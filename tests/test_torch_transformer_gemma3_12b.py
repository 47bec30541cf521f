"""gemma3-12b SMOKE (5 local sliding-window layers with ring caches, 1
global) through the port and the JAX package, whose attention runs the
Pallas kernel in interpret mode: ``forward``, ``prefill`` (logits and
caches) and three ``decode_step``s."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype, monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    compare("gemma3-12b", dtype)
