"""One rank of the multi-process checks of ``test_torch_mesh_dist.py``
(a program, not a test module: it holds no tests).

Run as ``python tests/test_torch_mesh_worker.py RANK WORLD INIT_FILE
CASES OUT``: it joins a ``gloo`` process group through
``file://INIT_FILE``; for each case in the file CASES (``torch.save`` of
a dict name -> case) it builds the case's mesh over the group, lays the
case's params (and batches, optimizer state or cache) out as the mesh
plan says and runs the port's train steps (one a batch) or decode steps
on the CPU; rank 0 writes each case's results, gathered to full tensors,
into OUT (a dict name -> results).  Imports nothing of JAX.
"""

import sys

import torch
import torch.distributed as dist


def main(rank: int, world: int, init_file: str, case_file: str,
         out_file: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    cases = torch.load(case_file, weights_only=False)
    results = {name: run(case) for name, case in cases.items()}
    if rank == 0:
        torch.save(results, out_file)
    dist.barrier()
    dist.destroy_process_group()


def run(case):
    """One case on the process group: its results, gathered."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core import hints, meshplan
    from repro_torch.core.pytree import leaves_with_path
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg = case["cfg"]
    mesh = make_mesh(case["mesh"], ("data", "model"), device="cpu")
    B, S = case["batch"], case["seq"]
    meshplan.DECODE_SCATTER_UPDATE = case.get("scatter", False)
    plan = meshplan.plan_model(cfg, mesh, case["mode"], B, S,
                               override=case.get("override"))
    params = meshplan.distribute(
        case["params"], meshplan.tree_shardings(plan, mesh, case["params"]))
    hints.set_hints(plan.hints, mesh)
    out = {"strategy": plan.strategy, "hints": dict(plan.hints)}
    if case["mode"] == "train":
        opt = adamw.init(params)
        sh = adamw.zero1_shardings(plan, mesh, params, opt)
        opt = adamw.AdamWState(opt.step, meshplan.distribute(opt.m, sh.m),
                               meshplan.distribute(opt.v, sh.v))
        step = make_train_step(
            cfg, adamw.AdamWConfig(**case["opt"]), remat=case["remat"],
            microbatches=case["micro"],
            accum_specs=adamw.zero_specs(plan, mesh, params))
        out["loss"], out["grad_norm"] = [], []
        for data in case["data"]:
            batch = meshplan.distribute(
                data, meshplan.batch_shardings(plan, mesh, data))
            params, opt, metrics = step(params, opt, batch)
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
        trees = {"params": params, "m": opt.m, "v": opt.v}
        out["moment_placements"] = {
            "/".join(p): str(t.placements)
            for p, t in leaves_with_path(opt.m)}
    else:
        model = get_model(cfg)
        cache = meshplan.distribute(
            case["cache"],
            meshplan.cache_shardings(plan, mesh, case["cache"], B))
        logits = []
        with implicit_replication():
            for tok in case["tokens"]:
                t = meshplan.distribute(
                    {"t": tok}, meshplan.batch_shardings(plan, mesh,
                                                         {"t": tok}))["t"]
                lg, cache = model.decode_step(cfg, params, cache, t)
                logits.append(lg.full_tensor())
        trees = {}
        out["logits"] = torch.stack(logits)
    out["trees"] = {name: {"/".join(p): t.full_tensor()
                           for p, t in leaves_with_path(tree)}
                    for name, tree in trees.items()}
    hints.set_hints(None)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
