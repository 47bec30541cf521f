"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

End-to-end driver, the JAX package's ``repro/launch/train.py``: config ->
mesh -> mesh-plan layouts -> params (``model.init`` from an explicitly
seeded ``torch.Generator``) -> data pipeline -> train step (remat, AdamW,
the state donated to the step as the JAX launcher's jit donates it)
under the fault supervisor (checkpoint/restart + straggler watch).

The mesh: when a process group is set up (``torch.distributed``), the
launcher builds ``launch/mesh.make_host_mesh()`` over it (1 x 1 over a
one-rank group on one card), plans it with ``meshplan.plan_model(cfg,
mesh, "train", batch, seq)``, lays params out by ``tree_shardings`` and
each batch by ``batch_shardings``, and the step runs on DTensors; with
no process group it runs on plain tensors on one device.  Runs on
``cuda`` unless the caller passes
``device="cpu"``; ``--full`` takes the config's published widths and
depth (internlm2-1.8b, rwkv6-3b, recurrentgemma-2b and
granite-moe-3b-a800m at full size fit one H100 with their AdamW state;
olmoe-1b-7b and the larger dense configs need a mesh of several cards),
the default its smoke size.  Weights can also come from the JAX package
(``core/weights.py:tree_from_jax``), which the tests do.

The state handed to the supervisor as its initial state is the one the
step writes into, so it does not stay the initial state: a restart with
no checkpoint to go back to (the supervisor's fallback to its initial
state) would resume from trained params and moments with the step count
at 0.  The launcher refuses such a restart; with a checkpoint directory
step 0 is always saved, so a restart after it has one.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import meshplan
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.fault.supervisor import Supervisor, SupervisorConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step


def train(arch: str, steps: int = 50, batch: int = 8, seq: int = 128,
          smoke: bool = True, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, microbatches: int = 1,
          log_every: int = 10, seed: int = 0,
          num_docs: int = 0, device="cuda") -> Dict[str, Any]:
    cfg = registry.get_smoke_config(arch) if smoke \
        else registry.get_config(arch)
    model = get_model(cfg)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on "
                           "the CPU")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, cfg, dev)
    place = None
    if dist.is_available() and dist.is_initialized():
        dmesh = make_host_mesh(device=dev.type)
        plan = meshplan.plan_model(cfg, dmesh, "train", batch, seq)
        params = meshplan.distribute(
            params, meshplan.tree_shardings(plan, dmesh, params))

        def place(b):
            return meshplan.distribute(
                b, meshplan.batch_shardings(plan, dmesh, b))
    opt_cfg = adamw.AdamWConfig(total_steps=steps, warmup_steps=steps // 10)
    opt_state = adamw.init(params)
    # the JAX launcher jits the step with donate_argnums=(0, 1); here the
    # step writes into the state it is given, so one state lives on the
    # card (internlm2-1.8b: params and fp32 moments 18.9 GB) however long
    # the supervisor keeps its initial state
    step_fn = make_train_step(cfg, opt_cfg, remat=True,
                              microbatches=microbatches, donate=True)

    data = Pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        embed_dim=cfg.d_model if cfg.input_kind == "embeds" else 0,
        num_docs=num_docs))

    losses = []
    state = {"params": params, "opt": opt_state}

    donated = []

    def one_step(state, step_idx):
        if step_idx == 0 and donated:
            raise RuntimeError("restart from the initial state, which the "
                               "step has overwritten: no checkpoint to "
                               "restart from")
        # the pipeline's numpy arrays, in their dtypes, on the device
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        if place is not None:
            b = place(b)
        params, opt, metrics = step_fn(state["params"], state["opt"], b)
        donated.append(step_idx)
        losses.append(float(metrics["loss"]))
        if step_idx % log_every == 0:
            print(f"  step {step_idx:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        return {"params": params, "opt": opt}

    if ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir)
        sup = Supervisor(SupervisorConfig(total_steps=steps,
                                          ckpt_every=ckpt_every), ckpt)
        report = sup.run(state, one_step, state_like=state)
        state = report.final_state
    else:
        for i in range(steps):
            state = one_step(state, i)
    return {"losses": losses, "state": state, "config": cfg}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default is smoke)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, batch=args.batch,
                seq=args.seq, smoke=not args.full,
                ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
                device=args.device)
    losses = out["losses"]
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
