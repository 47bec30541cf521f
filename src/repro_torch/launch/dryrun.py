"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

``python -m repro_torch.launch.dryrun [--arch A] [--shape S]
[--mesh single|multi|both] [--out DIR] [--capacity-gib G]``: the JAX
package's ``launch/dryrun.py`` for the port, with its CLI, its record
fields and its ``dry-run: N ok, N skip, N FAIL`` line, exiting 1 on a
fail.

How a cell runs.  A ``fake`` process group of 256 ranks (the 16 x 16
("data", "model") mesh) or 512 (2 x 16 x 16 with "pod") stands in for
the pod, and ``FakeTensorMode`` for its memory: tensors carry shapes,
dtypes and devices, no data, and collectives move nothing.  Params,
optimizer state, batch and cache come from the registry's specs
(``configs/registry.py``: meta tensors), are made fake, and are laid out
as DTensors by the mesh plan (``core/meshplan.py``: ``tree_shardings``,
ZeRO-1 ``zero1_shardings`` when the memory plan says so,
``batch_shardings``, ``cache_shardings``); then the train step, prefill
or decode step runs on them op by op, with the plan's hints set.  The
kernels' wrappers take their storage-less branch (``kernels/dry.py``):
outputs of the right shapes, the kernel's own operations and bytes
tallied.

What a record holds.  A dispatch mode under DTensor sees each rank's
local ops (rank 0's: the ranks run alike), so ``flops`` is per device,
as XLA's SPMD ``cost_analysis`` gives it (not the global count that
``FlopCounterMode`` reports over DTensors): the ops' counts from
``torch.utils.flop_counter`` plus the kernels'.  ``hlo_bytes`` is the
bytes the ops read and write, and the kernels'.  ``collectives`` holds
the result bytes of each ``_c10d_functional`` collective by kind (this
takes the place of the JAX package's regex over the optimized HLO).
``memory`` holds per-device bytes of the local shards: the arguments
(the placed inputs), the outputs, the temporaries (the most bytes that
ops' fresh results held alive at once during the step) and the peak
(arguments plus temporaries, as the JAX package adds them).  ``hbm_plan``
comes from ``core/hbmplan.plan_memory`` at ``--capacity-gib``, or at the
card's memory when none is given (which raises without a card, as the
planner does), for a train cell.

Cost correction.  Eager tracing runs every layer, so ``cost_correction``
is ``"none"`` and ``flops`` equals ``flops_raw``: the JAX package's
``_body_cost`` probes and ``stacking.FORCE_UNROLL`` exist only because
XLA's cost analysis counts a while loop's body once, and have no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.core import hints, meshplan
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.kernels import dry

GiB = 2.0 ** 30

# _c10d_functional op -> the JAX package's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running an op on
    global-shaped fake tensors to learn its output's shape (not one of the
    rank's ops)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class Tally(TorchDispatchMode):
    """Counts each rank-local op under DTensor: its FLOPs (the
    ``torch.utils.flop_counter`` formulas), the bytes it reads and
    writes, a collective's result bytes by kind, and the bytes that ops'
    fresh results hold alive (``live``, ``peak``).  An op on DTensors is
    passed to DTensor (``NotImplemented``), whose local ops come back
    here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += float(self._flops[packet](*args, **kwargs,
                                                    out_val=out))
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional" and name in _KINDS:
            kind = _KINDS[name]
            self.collectives[kind] = (self.collectives.get(kind, 0.0)
                                      + sum(_nbytes(o) for o in outs))
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        # a result that aliases no input is a fresh allocation, alive
        # until the tensor is freed
        fresh = [r.alias_info is None for r in func._schema.returns]
        if len(fresh) == len(outs):
            for o, new in zip(outs, fresh):
                if new:
                    n = _nbytes(o)
                    self.live += n
                    weakref.finalize(o, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def init_fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks (this process is rank
    0), replacing any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake(tree):
    """Fake CPU tensors in the shapes and dtypes of ``tree``'s (meta)
    tensors; call under ``FakeTensorMode``."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _build_and_trace(cfg, shape, mesh, capacity: Optional[float]):
    """Lays the cell's inputs out on ``mesh`` and runs its step on them
    under :class:`Tally`; returns (record fields, the plan)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.hbmplan import plan_memory
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    axes = meshplan.mesh_axes(mesh)
    dp = mesh.size() // axes.get("model", 1)
    model = get_model(cfg)
    plan = meshplan.plan_model(cfg, mesh, shape.kind, shape.global_batch,
                               shape.seq_len)
    out: Dict = {"strategy": plan.strategy}
    params_s = registry.param_specs(cfg)
    hints.set_hints(plan.hints, mesh)
    dry.reset()
    try:
        with FakeTensorMode():
            params = meshplan.distribute(
                _fake(params_s),
                meshplan.tree_shardings(plan, mesh, params_s))
            if shape.kind == "train":
                mem = plan_memory(cfg, shape.global_batch, shape.seq_len,
                                  dp, axes.get("model", 1),
                                  capacity_bytes=capacity)
                out["hbm_plan"] = {"remat": mem.remat, "zero1": mem.zero1,
                                   "est_gib": round(mem.total / GiB, 2)}
                micro = mem.microbatches
                out["microbatches"] = micro
                opt = adamw.init(params)
                if mem.zero1:
                    sh = adamw.zero1_shardings(plan, mesh, params_s, opt)
                    opt = adamw.AdamWState(
                        opt.step, meshplan.distribute(opt.m, sh.m),
                        meshplan.distribute(opt.v, sh.v))
                batch_s = registry.batch_input_specs(
                    cfg, shape.global_batch, shape.seq_len)
                batch = meshplan.distribute(
                    _fake(batch_s),
                    meshplan.batch_shardings(plan, mesh, batch_s))
                step = make_train_step(
                    cfg, adamw.AdamWConfig(), remat=mem.remat,
                    microbatches=micro,
                    accum_specs=(adamw.zero_specs(plan, mesh, params_s)
                                 if mem.zero1 and micro > 1 else None),
                    donate=True)
                args = (params, opt, batch)

                def run():
                    return step(params, opt, batch)
            else:
                out["microbatches"] = 1
                if shape.kind == "prefill":
                    x_s = registry.batch_input_specs(
                        cfg, shape.global_batch, shape.seq_len)["x"]
                    x = meshplan.distribute(
                        _fake({"x": x_s}),
                        meshplan.batch_shardings(plan, mesh,
                                                 {"x": x_s}))["x"]
                    args = (params, x)

                    def run():
                        return model.prefill(cfg, params, x, shape.seq_len)
                else:
                    cache_s = registry.cache_specs(
                        cfg, shape.global_batch, shape.seq_len)
                    cache = meshplan.distribute(
                        _fake(cache_s),
                        meshplan.cache_shardings(plan, mesh, cache_s,
                                                 shape.global_batch))
                    tok_s = registry.decode_input_specs(
                        cfg, shape.global_batch)
                    tok_sh = (meshplan.batch_shardings(plan, mesh, tok_s)
                              if shape.global_batch >= dp else
                              tree_map(lambda t: meshplan.Sharding(
                                  mesh, meshplan.Spec()), tok_s))
                    token = meshplan.distribute(_fake(tok_s),
                                                tok_sh)["token"]
                    args = (params, cache, token)

                    def run():
                        return model.decode_step(cfg, params, cache, token)

            arg_bytes = _local_bytes(args)
            out["param_bytes"] = _local_bytes(params)
            tally = Tally()
            with tally, implicit_replication():
                if shape.kind == "train":
                    result = run()
                else:
                    with torch.no_grad():
                        result = run()
            out_bytes = _local_bytes(result)
    finally:
        hints.set_hints(None)
    out["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": tally.peak,
                     "peak_bytes": arg_bytes + tally.peak}
    out["flops_raw"] = tally.flops + dry.flops
    out["hlo_bytes_raw"] = tally.bytes + dry.nbytes
    out["collectives_raw"] = dict(tally.collectives)
    out["kernel_calls"] = dict(dry.calls)
    return out, plan


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True,
               capacity: Optional[float] = None) -> Dict:
    """Trace one (arch x shape x mesh) cell on fake tensors; returns its
    record (memory, cost and collective analysis).  The process group
    must be a ``fake`` one of the mesh's size (:func:`init_fake_group`)."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.perf_counter()
    rec: Dict = {"arch": arch, "shape": shape_name,
                 "mesh": "x".join(map(str, mesh.shape)), "status": "ok"}
    try:
        fields, _ = _build_and_trace(cfg, shape, mesh, capacity)
        rec.update(fields)
        rec["lower_s"] = round(time.perf_counter() - t0, 1)
        rec["flops"] = rec["flops_raw"]
        rec["hlo_bytes"] = rec["hlo_bytes_raw"]
        rec["collectives"] = rec["collectives_raw"]
        rec["cost_correction"] = "none"
        if verbose:
            mm = rec["memory"]
            coll = {k: f"{v / 2**20:.0f}MiB"
                    for k, v in rec["collectives"].items()}
            print(f"  [{rec['mesh']}] {arch} x {shape_name}: OK "
                  f"args={mm['argument_bytes'] / GiB:.2f}GiB "
                  f"temp={mm['temp_bytes'] / GiB:.2f}GiB "
                  f"flops={rec['flops']:.3e} coll={coll}", flush=True)
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  [{rec['mesh']}] {arch} x {shape_name}: FAIL "
                  f"{rec['error']}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--capacity-gib", type=float, default=None,
                    help="device memory a card holds, for the memory "
                         "plan of a train cell (default: the card's)")
    args = ap.parse_args(argv)
    capacity = (None if args.capacity_gib is None
                else args.capacity_gib * GiB)

    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    records = []
    n_fail = 0
    for multi in meshes:
        init_fake_group(512 if multi else 256)
        print(f"=== mesh {'2x16x16 (multi-pod)' if multi else '16x16'} ===",
              flush=True)
        for arch in archs:
            for shape in shapes:
                rec = lower_cell(arch, shape, multi, capacity=capacity)
                records.append(rec)
                if rec["status"] == "fail":
                    n_fail += 1
                elif rec["status"] == "skip":
                    print(f"  {arch} x {shape}: SKIP ({rec['reason']})",
                          flush=True)
    with open(os.path.join(args.out, "dryrun.json"), "w") as f:
        json.dump(records, f, indent=1, default=str)
    ok = sum(r["status"] == "ok" for r in records)
    skip = sum(r["status"] == "skip" for r in records)
    print(f"\ndry-run: {ok} ok, {skip} skip, {n_fail} FAIL "
          f"-> {args.out}/dryrun.json", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
