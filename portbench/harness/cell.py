"""A cell of ``BENCHMARK.json``, found by name, and one run of it.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``portbench/configs/<config>.json``: the sizes as run (the file the
  configuration's ``file`` names), the port's arch id and the reference;
* ``portbench/traffic/<mix>.json``: the mix's parameters; its ``kind``
  names the driver (``portbench/harness/<kind>.py``) that runs it;
* ``portbench/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
* ``portbench/metrics/<metric>.py``: a reader, ``read(rec)`` returning
  the metric or None, and the spans (``SPANS``) it needs.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench.harness import weights

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, workload: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", "") in e2e_names or "moves" not in metric


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic"
                      / f"{entry['traffic']}.json").read_text())
    lim_file = root / "portbench" / "limits" / f"{workload}.json"
    limits = json.loads(lim_file.read_text()) if lim_file.exists() else {}
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, entry["chips"], config, mix, limits, e2e,
                per_layer)


def reader(metric: str, root: Path = ROOT):
    """The reader module of a per-layer metric (its file name may hold
    dots, so it is loaded by path)."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The program's side: its configuration and parameter tree, held to the file
# ---------------------------------------------------------------------------

def with_options(cfg, config: dict):
    """``cfg`` with the file's value of each setting that the port's
    ``ModelConfig`` takes as a field (the RoPE base)."""
    return dataclasses.replace(cfg, rope_theta=float(config["rope_theta"]))


def port_config(config: dict):
    """The port's ``ModelConfig`` for the file's arch, run with the file's
    settings, after holding every size it runs to the file's."""
    from repro_torch.configs import registry
    from repro_torch.models import layers, moe
    cfg = with_options(registry.get_config(config["arch"]), config)
    want = {
        "n_layers": config["num_hidden_layers"], "d_model":
        config["hidden_size"], "n_heads": config["num_attention_heads"],
        "n_kv": config["num_key_value_heads"], "head_dim_":
        config["head_dim"], "d_ff": config["intermediate_size"], "vocab":
        config["vocab_size"], "n_experts": config.get("num_local_experts", 0),
        "top_k": config.get("num_experts_per_tok", 0), "rope_theta":
        config["rope_theta"], "dtype": config["torch_dtype"], "window": None,
        "qk_norm": False, "causal": True, "unit": 1}
    got = {k: getattr(cfg, k) for k in want}
    got_eps = inspect.signature(layers.rmsnorm).parameters["eps"].default
    got_cap = moe.CAPACITY_FACTOR if want["n_experts"] else None
    want_cap = config.get("capacity_factor") if want["n_experts"] else None
    if got != want or got_eps != config["rms_norm_eps"] or got_cap != want_cap:
        raise SystemExit(f"the port's {config['arch']} runs {got}, eps "
                         f"{got_eps}, capacity factor {got_cap}; the "
                         f"configuration file states {want}, eps "
                         f"{config['rms_norm_eps']}, {want_cap}")
    return cfg


def port_tree(flat: Dict[str, torch.Tensor], cfg):
    """The port's parameter tree holding the tensors of ``flat`` (by path),
    after holding its layout (paths, shapes, dtypes) to them."""
    from repro_torch.configs import registry
    from repro_torch.core.pytree import tree_map_with_path
    seen = set()

    def take(path, spec):
        name = ".".join(path)
        t = flat.get(name)
        if t is None or tuple(t.shape) != tuple(spec.shape) \
                or t.dtype != spec.dtype:
            raise SystemExit(f"the port's leaf {name} {tuple(spec.shape)} "
                             f"{spec.dtype} is not in the benchmark's "
                             f"layout")
        seen.add(name)
        return t

    tree = tree_map_with_path(take, registry.param_specs(cfg))
    if seen != set(flat):
        raise SystemExit(f"leaves the port lacks: {sorted(set(flat) - seen)}")
    return tree


def flat_leaves(tree) -> Dict[str, torch.Tensor]:
    from repro_torch.core.pytree import leaves_with_path
    return {".".join(p): t for p, t in leaves_with_path(tree)}


def make_params(config: dict, cfg, seed: int, device):
    return port_tree(weights.make(config, seed, device), cfg)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, cfg=None, root: Path = ROOT) -> dict:
    """Run the cell once; returns the result line's object.  ``cfg``: the
    port's configuration, if not the file's (the CPU tests' small ones)."""
    from portbench.harness.spans import Spans
    readers = {m["name"]: reader(m["name"], root) for m in cell.per_layer} \
        if trace else {}
    span_names = sorted({s for r in readers.values()
                         for s in getattr(r, "SPANS", ())})
    spans = Spans(span_names, device) if trace else None
    if cfg is None:
        cfg = port_config(cell.config)
    driver = importlib.import_module(f"portbench.harness.{cell.mix['kind']}")
    if spans:
        spans.install()
    try:
        run = driver.run(cell, cfg, seed, seconds, device, t_start,
                         spans=spans, trace=trace)
    finally:
        if spans:
            spans.uninstall()
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(run.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in run.end_to_end]
        if missing:
            raise SystemExit(f"the {cell.mix['kind']} driver gives no "
                             f"{missing}")
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": dict(run.device)}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = run.checks
    print("set-up by part (s): " + json.dumps(run.setup_parts),
          file=sys.stderr)
    return out


@dataclasses.dataclass
class Run:
    """What a driver hands back."""
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    record: object                  # what the per-layer readers read
    device: dict
    checks: Dict[str, list]
    trace: Optional[dict] = None
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
