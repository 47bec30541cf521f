"""The harness on the CPU: the work counts against hand counts, a cell
added as files found by name, the result line's keys, what the
benchmark imports, and the refusal without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import cell as C
from portbench.tests.smoke import serving_cell, smoke_cell
from portbench.work import counts

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TOP_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


# -- work counts -------------------------------------------------------------

def test_attention_pairs_by_hand():
    # S 4 causal: 1 + 2 + 3 + 4; window 2: the diagonal and one below
    assert counts.attention_pairs(4, True, None) == 10
    assert counts.attention_pairs(4, True, 2) == 4 + 3
    assert counts.attention_pairs(4, False, None) == 16
    assert counts.attention_pairs(4, True, 0) == 0


def test_flash_attention_work_by_hand():
    # B1 S4 H2 KV1 Dh8 causal bf16: 10 pairs; forward QK^T and PV, 2 * 10 *
    # 8 flops each a head; q, out (1*4*2*8 each), k, v (1*4*1*8 each)
    (ff, fb), (bf, bb) = counts.flash_attention(1, 4, 2, 1, 8, True, None, 2)
    assert ff == 2 * (2 * 10 * 8) * 2
    assert fb == (64 + 64 + 32 + 32) * 2
    assert bf == 5 * (2 * 10 * 8) * 2
    assert bb == (4 * 64 + 4 * 32) * 2


def test_grouped_matmul_work_by_hand():
    (ff, fb), (bf, bb) = counts.grouped_matmul(2, 3, 4, 5, 2)
    assert ff == 2 * 2 * 3 * 4 * 5
    assert fb == (24 + 40 + 30) * 2
    assert bf == 2 * ff
    assert bb == (48 + 80 + 30) * 2


def test_model_flops_by_hand():
    cfg = {"num_hidden_layers": 1, "hidden_size": 4,
           "num_attention_heads": 2, "num_key_value_heads": 1,
           "head_dim": 2, "intermediate_size": 8, "vocab_size": 10}
    # q, o 4x4; k, v 4x2; gate, up 4x8; down 8x4; head 4x10
    per_token = 16 + 16 + 8 + 8 + 32 * 3 + 40
    assert counts.matmul_params_per_token(cfg) == per_token
    attn = 4.0 * 1 * 2 * 2 * 6          # S 3: 6 pairs, one row
    assert counts.train_step_flops(cfg, 1, 3) == 3 * (2 * per_token * 3
                                                      + attn)
    assert counts.prefill_flops(cfg, 3) == 2 * (per_token - 40) * 3 \
        + 2 * 40 + attn
    moe = dict(cfg, num_local_experts=4, num_experts_per_tok=2)
    assert counts.matmul_params_per_token(moe) == \
        48 + 4 * 4 + 2 * 3 * 4 * 8 + 40


def test_bound_takes_the_slower_of_operations_and_bytes():
    peak = counts.PEAKS["flops_per_s"]["bfloat16"]
    bw = counts.PEAKS["bytes_per_s"]
    assert counts.bound_s(peak, 0, "bfloat16") == 1.0
    assert counts.bound_s(1.0, bw * 2, "bfloat16") == 2.0


# -- cells found by name -----------------------------------------------------

def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "internlm2-1.8b.json").read_text())
    (root / "portbench" / "configs" / "new-model.json").write_text(
        json.dumps(dict(cfg, num_hidden_layers=2)))
    mix = json.loads((BENCH / "traffic" / "train-b4s1024.json").read_text())
    (root / "portbench" / "traffic" / "train-b2s64.json").write_text(
        json.dumps(dict(mix, batch=2, seq=64)))
    (root / "portbench" / "limits" / "new-model.train-b2s64.json"
     ).write_text(json.dumps({"loss": 1.0}))
    (root / "portbench" / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    return float(rec.steps)\n")
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "portbench/configs/new-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-model.train-b2s64",
                               "config": "new-model",
                               "traffic": "train-b2s64", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("new-model.train-b2s64")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step",
                               "moves": "train_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = C.load("new-model.train-b2s64", root=root)
    assert cell.config["num_hidden_layers"] == 2
    assert (cell.mix["batch"], cell.mix["seq"]) == (2, 64)
    assert cell.limits == {"loss": 1.0}
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s",
                                                    "setup_s"]
    # a metric with no workloads goes to every cell that reports its moves
    assert "steps.train" in [m["name"] for m in cell.per_layer]
    assert C.reader("steps.train", root=root).read(
        type("R", (), {"steps": 3})) == 3.0


# -- the result line ---------------------------------------------------------

@pytest.mark.parametrize("workload", ["internlm2-1.8b.train-b4s1024",
                                      "granite-moe-3b-a800m.train-b4s1024",
                                      None])       # None: the serving cell
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contract_keys(workload, trace):
    cell, cfg = smoke_cell(workload) if workload else serving_cell()
    out = C.execute(cell, 2 ** 31 + 5, 0.3, trace, torch.device("cpu"),
                    time.perf_counter(), cfg=cfg)
    assert set(out) == TOP_KEYS | ({"breakdown"} if trace else set())
    assert list(out)[-1] == "checks"
    want_dev = DEVICE_KEYS | ({"busy_s", "window_s"} if trace else set())
    assert set(out["device"]) == want_dev
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["attempted"] > 0 and out["failed"] == 0
    for value, limit, where in out["checks"].values():
        assert isinstance(value, float) and isinstance(where, str)
    json.dumps(out)


# -- imports -----------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in C.FORBIDDEN, (path, name)


def test_the_reference_and_the_work_counts_import_nothing_of_the_port():
    for sub in ("reference", "work"):
        for path in (BENCH / sub).rglob("*.py"):
            for name in _imports(path):
                assert name.split(".")[0] != "repro_torch", (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "from portbench.harness import cell as C;"
            "from portbench.tests.smoke import smoke_cell;"
            "import torch, time;"
            "c, cfg = smoke_cell('internlm2-1.8b.train-b4s1024');"
            "C.execute(c, 1, 0.1, True, torch.device('cpu'),"
            " time.perf_counter(), cfg=cfg);"
            "print(C.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- no card -----------------------------------------------------------------

def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "internlm2-1.8b.train-b4s1024", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "internlm2-1.8b.train-b4s1024", "--seed", str(2 ** 32 + 11),
         "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    for name, m in line["metrics"].items():
        if "mfu" in name or "roofline" in name:
            assert 0 < m["value"] <= 100, (name, m)


# -- the trace's reduction ---------------------------------------------------

def _device(*spans):
    return [((a, b), n) for a, b, n in spans]


def test_the_trace_window_lies_between_the_marks():
    from portbench.harness import trace
    device = _device((0, 10, "k0"), (20, 21, trace.MARK), (25, 35, "k1"),
                     (30, 40, "k2"), (50, 60, "k1"), (70, 71, trace.MARK),
                     (80, 90, "k3"))
    host = _device((40, 52, "cudaLaunchKernel"))
    out = trace.reduce(device, host, 1.0)
    assert out["window_s"] == pytest.approx(49e-6)      # 21 .. 70
    assert out["busy_s"] == pytest.approx(25e-6)       # 25-40, 50-60
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)   # 40 .. 50
    assert gaps["(no host operation)"] == pytest.approx(14e-6)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(20e-6) and "k3" not in ops


def test_a_lost_mark_falls_back_to_the_syncs():
    from portbench.harness import trace
    device = _device((0, 10, "k0"), (25, 35, "k1"), (70, 71, trace.MARK))
    host = _device((15, 20, trace.SYNC), (60, 69, trace.SYNC),
                   (72, 75, trace.SYNC))
    out = trace.reduce(device, host, 1.0)
    assert out["window_s"] == pytest.approx(49e-6)      # 20 .. 69
    assert out["busy_s"] == pytest.approx(10e-6)


# -- the configuration as run ------------------------------------------------

def test_the_port_runs_the_files_rope_base():
    config = C.load("internlm2-1.8b.train-b4s1024").config
    assert config["rope_theta"] == 1e6
    assert C.port_config(config).rope_theta == 1e6
