"""``examples/custom_soc_torch.py``, the port's twin of
``examples/custom_soc.py``, run whole on the CPU: its own SoC and pattern
catalogue, a transformer block compiled in two modes, each plan held to
whole-graph evaluation by the twin's oracle asserts; the MATCHA plan run
by the JAX runtime and the port's on the same seeded values at 1e-4; and
no run on a missing card."""

import pytest
import torch

from test_torch_examples_quickstart import jax_vs_port, load_example


@pytest.fixture(scope="module")
def custom_soc():
    return load_example("custom_soc_torch")


def test_custom_soc_twin_runs_whole_on_the_cpu(custom_soc):
    res = custom_soc.main(["--device", "cpu"])
    assert sorted(res) == ["match", "matcha"]
    for cm in res.values():
        assert cm.soc.name == "my_soc"
        assert set(cm.plan.utilization()) >= {"cpu", "npu", "dsp"}
    jax_vs_port(res["matcha"].plan)


def test_custom_soc_twin_refuses_a_missing_card(custom_soc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        custom_soc.main([])
