"""One fp32 train step of the recurrent and hybrid families at smoke size
through the port and the JAX package (the comparison of
tests/test_torch_train.py's ``test_train_step_matches_jax``, in a file of
its own so that the suite's parallel workers run it beside the other
files): rwkv6-3b through WKV6, recurrentgemma-2b through the RG-LRU scan
and windowed MQA; the loss, every gradient, every updated param and both
moments."""

import pytest

from test_torch_train import check_train_step


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_train_step_matches_jax(arch, monkeypatch):
    """rwkv6-3b and recurrentgemma-2b: one step, loss, grads, params and
    moments against the JAX package's jitted step."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    check_train_step(arch)
