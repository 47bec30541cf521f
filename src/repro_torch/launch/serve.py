"""Serving launcher: ``python -m repro_torch.launch.serve --lm rwkv6``.

Builds a two-tenant deployment — one shape-bucketed LM tenant next to a
fixed-shape vision-style tenant — and drains a synthetic
prefill-then-decode trace through the co-scheduling
:class:`~repro.serve.engine.MultiModelEngine`, reporting round
decomposition, background-compile activity and throughput.

This replaced the old single-model token-loop ``Engine`` launcher: LM
traffic now goes through the same engine as everything else, as
bucketed requests (prefill at the prompt's power-of-two bucket, decode
at seq=1), so prefill/decode rounds co-schedule with the vision
tenant's work instead of serializing around it.
"""

from __future__ import annotations

import argparse

from repro_torch.core.deploy import CompileRequest, DeploymentSession
from repro_torch.models.lm_graphs import LM_FAMILIES, lm_tenant
from repro_torch.serve.compiler_thread import BackgroundCompiler
from repro_torch.serve.engine import MultiModelEngine
from repro_torch.soc.testbed import dense_chain, two_acc_soc


def build_engine(lm: str = "rwkv6", max_seq: int = 32, d: int = 64,
                 ffn: int = 128, prefetch: bool = True,
                 execute: bool = False, device="cuda"):
    """A compiled two-tenant (vision + bucketed LM) serving engine with
    a deterministic (no-thread) background compiler attached."""
    soc, pats = two_acc_soc(512, 8.0)
    lm_graph, lm_spec = lm_tenant(lm, max_seq=max_seq, d=d, ffn=ffn)
    vision = dense_chain("vision", [64, 64, 64])
    session = DeploymentSession(CompileRequest(
        graphs=[vision, lm_graph], soc=soc, patterns=pats,
        requested_tiles=4, time_budget_s=0.5,
        joint_time_budget_s=1.0, lazy_joint_time_budget_s=0.5,
        incremental_time_budget_s=0.5,
        shape_buckets={1: lm_spec}))
    mc = session.compile()
    compiler = BackgroundCompiler(session, start=False, prefetch=prefetch)
    eng = MultiModelEngine(mc, execute=execute, async_compile=compiler,
                           device=device)
    return eng, compiler


def serve(lm: str = "rwkv6", n_prompts: int = 4, decode_steps: int = 8,
          max_seq: int = 32, prefetch: bool = True, execute: bool = False,
          seed: int = 0, device="cuda"):
    """Drain a synthetic trace: each prompt submits one prefill request
    (at its length's bucket) followed by ``decode_steps`` decode
    requests (bucket 1), with the vision tenant submitting alongside
    every step.  Returns the engine's report."""
    import random
    rng = random.Random(seed)
    eng, compiler = build_engine(lm, max_seq=max_seq, prefetch=prefetch,
                                 execute=execute, device=device)
    for _ in range(n_prompts):
        eng.submit(1, seq_len=rng.randint(2, max_seq))    # prefill
        eng.submit(0)                                     # vision rides
        compiler.run_pending()      # drain arrival-time hints pre-round
        eng.step()
        for _ in range(decode_steps):
            eng.submit(1, seq_len=1)                      # decode
            eng.submit(0)
            compiler.run_pending()
            eng.step()
    eng.run()
    rep = eng.report()
    print(f"{lm}+vision: served {rep['served']} in {rep['rounds']} rounds "
          f"(co {rep['co_rounds']}, floor {rep['floor_rounds']}), "
          f"throughput {rep['throughput_inf_per_s']:.1f} inf/s")
    ac = rep["async_compiler"]
    print(f"  background compiles: {ac['compiled']} "
          f"(prefetch {ac['prefetch_compiled']}), "
          f"store: {rep['plan_store']}")
    return rep


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lm", default="rwkv6",
                    choices=sorted(LM_FAMILIES))
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--execute", action="store_true",
                    help="run the numeric execution, not just the "
                         "analytic timing model")
    ap.add_argument("--device", default="cuda",
                    help="where --execute runs (cuda, or cpu for the "
                         "kernels' plain torch versions)")
    args = ap.parse_args()
    serve(args.lm, n_prompts=args.prompts,
          decode_steps=args.decode_steps,
          prefetch=not args.no_prefetch, execute=args.execute,
          device=args.device)


if __name__ == "__main__":
    main()
