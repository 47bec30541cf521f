"""internlm2-1.8b SMOKE (GQA) through the port and the JAX package:
``forward``, ``prefill`` (logits and caches) and three ``decode_step``s."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype):
    compare("internlm2-1.8b", dtype)
