"""rwkv6-3b SMOKE (Finch: data-dependent decay, WKV6 state) through the
port and the JAX package, whose WKV6 runs the Pallas kernel in interpret
mode: ``forward``, ``prefill`` (logits and recurrent states) and three
``decode_step``s, at a prompt inside one 32-token chunk and at one that
crosses it.  The JAX side runs op by op, as the port does
(``eager``, see tests/test_torch_lm_pair.py)."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("S", [24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype, S, monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    compare("rwkv6-3b", dtype, S=S, max_seq=S + 8, eager=True)
