"""hubert-xlarge SMOKE (non-causal encoder, frame embeddings in) through
the port and the JAX package, whose attention runs the Pallas kernel in
interpret mode: ``forward``, ``prefill`` (logits and caches) and three
``decode_step``s (the shape rules give hubert no decode; the functions
still agree)."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype, monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    compare("hubert-xlarge", dtype)
