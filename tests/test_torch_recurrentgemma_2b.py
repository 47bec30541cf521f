"""recurrentgemma-2b SMOKE (RG-LRU recurrent blocks + MQA local
attention, pattern rec, rec, attn) through the port and the JAX package,
whose RG-LRU scan and flash attention run the Pallas kernels in
interpret mode: ``forward``, ``prefill`` (logits, recurrent states and
ring KV caches) and three ``decode_step``s.  Both prompt lengths exceed
the SMOKE window of 16, so the ring is rolled; 128 crosses the scan's
64-token chunk.  The JAX side runs op by op, as the port does
(``eager``, see tests/test_torch_lm_pair.py)."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("S", [24, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype, S, monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    compare("recurrentgemma-2b", dtype, S=S, max_seq=S + 8,
            eager=True)
