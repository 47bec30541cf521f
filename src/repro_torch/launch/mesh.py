"""Device meshes over the process group that is already set up.

Functions only, never module-level meshes: importing this module touches
no device and no process group.  Each builds a ``DeviceMesh`` with
``init_device_mesh`` over the default process group, which the caller
has initialised (``torch.distributed.init_process_group``, or a ``fake``
group of 256 or 512 ranks for the dry run), on ``cuda`` unless the caller
asks for ``cpu``.  Each raises when no process group exists, or when the
group's size is not the mesh's.
"""

from __future__ import annotations

import math
from typing import Tuple


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = "cuda"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model_par: int = 1, device: str = "cuda"):
    """(ranks / model_par) x model_par mesh over the whole process group:
    a 1x1 mesh over a one-rank group on one card."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    n = dist.get_world_size()
    return make_mesh((n // model_par, model_par), ("data", "model"), device)
