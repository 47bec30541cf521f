"""Parameters handed over from the JAX package.

The two packages draw their parameters from the same numpy streams, so a
test can build them on either side; a JAX pytree of weights can also be
carried over as numpy arrays, which is what this module takes."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(arrays: Mapping[str, np.ndarray],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` -> ``{name: tensor on device}``, values and
    dtypes unchanged (each array is copied, so the tensors own their
    memory)."""
    return {name: torch.from_numpy(np.array(a, copy=True)).to(device)
            for name, a in arrays.items()}
