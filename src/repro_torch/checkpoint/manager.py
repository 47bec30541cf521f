"""Checkpointing: manifest-described, async-saved, restored by shape.

The JAX package's ``repro/checkpoint/manager.py`` over pytrees of
tensors, with the same layout per step::

    <dir>/step_000042/
        manifest.json        # leaf names, files, shapes, dtypes
        data/<leaf-id>.npy   # one file per leaf, in JAX's leaf order
        DONE                 # commit marker (atomic finish)

* ``save`` copies the tree to host memory synchronously and writes it on a
  background thread (training continues), keeping at most ``keep``
  finished checkpoints; an unfinished directory (no DONE) is ignored by
  ``latest_step``, so a crash mid-write leaves the last one standing.
* ``restore`` rebuilds ``like``'s structure from the manifest, each leaf
  in ``like``'s dtype and on its device.  A DTensor leaf (a state laid
  out on a device mesh) is written whole and restored in its ``like``'s
  layout.
* bfloat16: numpy has no such type without ``ml_dtypes``, which the port
  does not need.  A bf16 leaf is written as its 16-bit patterns in a
  2-byte void array, the bytes and ``.npy`` header the JAX manager writes
  for the same leaf (``<V2``), and the manifest says ``bfloat16``; on
  restore such a leaf (from either package) is viewed as bf16 again, so
  checkpoints cross between the packages and round-trip bitwise.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.on_mesh import on_mesh
from repro_torch.core.pytree import leaves_with_path, unflatten

_BF16_BYTES = np.dtype("V2")


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [("_".join(path), leaf) for path, leaf in leaves_with_path(tree)]


def _to_host(x) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array to write, the dtype the manifest names)."""
    if isinstance(x, torch.Tensor):
        if on_mesh(x):            # a DTensor: the whole tensor is written
            x = x.full_tensor()
        # a copy even of a CPU tensor: the background write must not see
        # a training step that updates the tree in place
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BYTES), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _save(path: str, a: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf's header names ``<V2`` as the JAX
    manager's does (numpy would write ``|V2`` for the same bytes)."""
    if dtype != "bfloat16":
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.require(a, requirements="C")     # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- query ---------------------------------------------------------------
    def finished_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "DONE")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.finished_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write to disk async."""
        self.wait()
        host = [(name, *_to_host(leaf)) for name, leaf in _flatten(tree)]

        def _write() -> None:
            path = os.path.join(self.dir, f"step_{step:06d}")
            tmp = path + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(os.path.join(tmp, "data"))
            manifest = {"step": step, "leaves": []}
            for i, (name, leaf, dtype) in enumerate(host):
                fn = f"{i:05d}.npy"
                _save(os.path.join(tmp, "data", fn), leaf, dtype)
                manifest["leaves"].append({
                    "name": name, "file": fn,
                    "shape": list(np.shape(leaf)),
                    "dtype": dtype,
                })
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "DONE"), "w") as f:
                f.write("ok")
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = self.finished_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Rebuild the pytree of ``like``'s structure from disk, each leaf
        in ``like``'s leaf's dtype and on its device (a non-tensor leaf of
        ``like`` takes the stored array's dtype, as a numpy array)."""
        path = os.path.join(self.dir, f"step_{step:06d}")
        if not os.path.exists(os.path.join(path, "DONE")):
            raise FileNotFoundError(f"checkpoint {step} not finished")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = [leaf for _, leaf in _flatten(like)]
        if len(flat) != len(manifest["leaves"]):
            raise ValueError(f"leaf count mismatch: {len(flat)} vs "
                             f"{len(manifest['leaves'])}")
        restored = []
        for ref, entry in zip(flat, manifest["leaves"]):
            a = np.load(os.path.join(path, "data", entry["file"]))
            t = _from_host(a, entry["dtype"])
            if on_mesh(ref):
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(
                    t.to(device=ref.device, dtype=ref.dtype),
                    ref.device_mesh, ref.placements)
            elif isinstance(ref, torch.Tensor):
                t = t.to(device=ref.device, dtype=ref.dtype)
            else:
                t = t.numpy()
            restored.append(t)
        return unflatten(like, restored)
