"""qwen3-32b SMOKE (qk-norm, GQA 8:2, Dh 8) through the port and the JAX
package: ``forward``, ``prefill`` (logits and caches) and three
``decode_step``s."""

import pytest

from test_torch_lm_pair import compare


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax(dtype):
    compare("qwen3-32b", dtype)
