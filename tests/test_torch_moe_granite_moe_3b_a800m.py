"""granite-moe-3b-a800m SMOKE (5 experts, top-2, GQA, head width 12)
through the port and the JAX package, whose grouped matmul and attention
run the Pallas kernels in interpret mode: ``forward``, ``prefill``
(logits and caches) and three ``decode_step``s, the JAX side op by op
(``eager``, see tests/test_torch_lm_pair.py).  The MoE layer's own tests
(routing, overflow, dense equivalence) run for both MoE configs in
tests/test_torch_moe_olmoe_1b_7b.py."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("S", [24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype, S, monkeypatch):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    compare("granite-moe-3b-a800m", dtype, S=S, max_seq=S + 8, eager=True)
