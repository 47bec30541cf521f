"""Parameters handed over from the JAX package.

The two packages draw their parameters from the same numpy streams, so a
test can build them on either side; a JAX pytree of weights can also be
carried over as numpy arrays, which is what this module takes.  Arrays
are carried bitwise, bf16 included: numpy knows bf16 only through the
``ml_dtypes`` extension type, which ``torch.from_numpy`` refuses, so a
bf16 array crosses as its 16-bit pattern and is viewed as bf16 again."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) -> a tensor on
    ``device`` with the same values and dtype; the tensor owns its memory."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tree_from_jax(tree: Any, device="cuda") -> Any:
    """A nested pytree (dicts, lists and tuples whose leaves are arrays)
    -> the same structure with every leaf a tensor on ``device``."""
    if isinstance(tree, Mapping):
        return {k: tree_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
