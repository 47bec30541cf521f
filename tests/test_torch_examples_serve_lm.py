"""``examples/serve_lm_torch.py``, the port's twin of
``examples/serve_lm.py``, run whole on the CPU through
``repro_torch.launch.serve``: the analytic run, as the original's
default, and ``--execute`` with every served round executed on CPU tensors
(the kernels' plain versions); each drains the trace with the lattice
prefetcher and no floor round; and no run on a missing card."""

import pytest
import torch

from test_torch_examples_quickstart import load_example


@pytest.fixture(scope="module")
def twin():
    return load_example("serve_lm_torch")


@pytest.mark.parametrize("argv", [[], ["--execute"],
                                  ["--lm", "transformer", "--execute"]],
                         ids=["analytic", "execute", "transformer-execute"])
def test_serve_lm_twin_runs_whole_on_the_cpu(twin, argv):
    rep = twin.main(argv + ["--device", "cpu", "--prompts", "2"])
    # each prompt: a prefill and 6 decode steps, the vision tenant beside
    assert rep["served"] == 2 * (1 + 6) * 2
    assert rep["floor_rounds"] == 0
    assert rep["starvation_events"] == 0


def test_serve_lm_twin_refuses_a_missing_card(twin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.main(["--execute"])
