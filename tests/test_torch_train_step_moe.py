"""One fp32 train step of the MoE family at smoke size through the port
and the JAX package (the comparison of tests/test_torch_train.py's
``test_train_step_matches_jax``, in a file of its own so that the suite's
parallel workers run it beside the other files): granite-moe-3b-a800m and
olmoe-1b-7b through the grouped matmul and top-k routing; the loss, every
gradient, every updated param and both moments."""

import pytest

from test_torch_train import check_train_step


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "olmoe-1b-7b"])
def test_train_step_matches_jax(arch, monkeypatch):
    """granite-moe-3b-a800m and olmoe-1b-7b: one step, loss, grads, params
    and moments against the JAX package's jitted step."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    check_train_step(arch)
