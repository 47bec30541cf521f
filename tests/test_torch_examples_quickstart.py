"""``examples/quickstart_torch.py``, the port's twin of
``examples/quickstart.py``, run whole on the CPU (``--device cpu``): four
toolchain modes, each plan held to whole-graph evaluation by the twin's
own oracle asserts, the artifact emitted where ``--out`` says; the twin
refuses to run on a missing card; and the MATCHA plan it compiled, run by
the JAX package's runtime and the port's on the same numpy-seeded values,
agrees at the runtime's 1e-4 contract.

Also the helpers that the other ``tests/test_torch_examples_*.py`` files
share: :func:`load_example` and :func:`jax_vs_port`."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import runtime as jrt
from repro_torch.core import runtime as trt
from repro_torch.core.weights import tree_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


def load_example(name: str):
    """The module ``examples/<name>.py``, imported under its own name."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_port(arrays):
    return tree_from_jax({k: np.asarray(v) for k, v in arrays.items()},
                         device="cpu")


def jax_vs_port(plan, seed: int = 0) -> None:
    """One plan the twin compiled, executed by the JAX runtime and by the
    port's on the same seeded parameters and inputs, held at 1e-4."""
    g = plan.tiled.graph
    jparams, jinputs = jrt.init_params(g, seed), jrt.init_inputs(g, seed + 1)
    want = jrt.execute_plan(plan, jinputs, jparams)
    got = trt.execute_plan(plan, _to_port(jinputs), _to_port(jparams))
    for t in g.outputs:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   err_msg=f"{g.name}:{t}", **TOL)


def jax_vs_port_multi(plan, seed: int = 0) -> None:
    """The same for a multi-tenant plan: each tenant's outputs of
    ``execute_multi_plan`` in both runtimes."""
    jp = [jrt.init_params(tg.graph, seed + 2 * i)
          for i, tg in enumerate(plan.tenants)]
    ji = [jrt.init_inputs(tg.graph, seed + 2 * i + 1)
          for i, tg in enumerate(plan.tenants)]
    want = jrt.execute_multi_plan(plan, ji, jp)
    got = trt.execute_multi_plan(plan, [_to_port(x) for x in ji],
                                 [_to_port(p) for p in jp])
    for i, tg in enumerate(plan.tenants):
        for t in tg.graph.outputs:
            np.testing.assert_allclose(got[i][t].numpy(),
                                       np.asarray(want[i][t]),
                                       err_msg=f"{tg.graph.name}:{t}", **TOL)


@pytest.fixture(scope="module")
def quickstart():
    return load_example("quickstart_torch")


def test_quickstart_twin_runs_whole_on_the_cpu(quickstart, tmp_path):
    out = tmp_path / "deploy"
    res = quickstart.main(["--device", "cpu", "--out", str(out)])
    assert sorted(res["compiled"]) == ["match", "matcha", "matcha_nt", "tvm"]
    assert sorted(p.name for p in out.iterdir()) == sorted(res["files"])
    assert "schedule.json" in res["files"]
    jax_vs_port(res["compiled"]["matcha"].plan)


def test_quickstart_twin_refuses_a_missing_card(quickstart, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        quickstart.main(["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
