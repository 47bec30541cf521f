"""The comparisons that decide ``correct``, and the reference's side of
them.

Training: the program's first ``check_steps`` optimizer steps (the
window's own step function and feed, in the set-up) against the
reference's same steps from the same weights and rows:

* ``loss``: the largest relative gap of a step's loss;
* ``grad``: the first step's gradient as the optimizer got it (clipped;
  the program's worked out from its first moment, m / (1 - beta1)), by
  the worst part: the gap of the program's norm to the reference's over
  the larger of the reference's norm of that part and of the median part;
* ``grad_median``: the same gap of the median part (a MoE router's
  gradient swings with near-tied expert choices that bf16 flips, so the
  worst part can be a router's on sound runs);
* ``change``: the same for each part's change over the steps, leaving out
  the parts whose reference gradient is under a thousandth of the median
  part's (they move by round-off alone).

A part is a layer of a stacked leaf, or a leaf that is not stacked.

Serving: a sample of the requests the window served, drawn from the seed
and holding a longest prompt, run again by the reference:

* ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best;
* ``logits``: the largest relative L2 error of the served position's
  logits;
* ``kv``: the largest relative L2 error of a layer's K or V in the cache
  the program wrote, over a smaller sample.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from portbench.harness import traffic, weights
from portbench.reference import decoder as ref

Norms = Dict[str, float]


def part_norms(path: str, t: torch.Tensor) -> Norms:
    return {name: float(torch.linalg.vector_norm(p.float()))
            for name, p in weights.slices(path, t)}


def worst_gap(prog: Norms, want: Norms, parts=None) -> Tuple[float, str]:
    med = statistics.median(want.values())
    worst, at = 0.0, ""
    for k in (parts if parts is not None else want):
        g = abs(prog[k] - want[k]) / max(want[k], med)
        if g >= worst:
            worst, at = g, k
    return worst, at


def moving_parts(grad: Norms) -> List[str]:
    med = statistics.median(grad.values())
    return [k for k, v in grad.items() if v >= 1e-3 * med]


def median_gap(prog: Norms, want: Norms) -> Tuple[float, str]:
    med = statistics.median(want.values())
    gaps = sorted((abs(prog[k] - want[k]) / max(want[k], med), k)
                  for k in want)
    return gaps[(len(gaps) - 1) // 2]


def train_numbers(prog: dict, want: dict) -> Dict[str, Tuple[float, str]]:
    """Each number with the step or part where it is worst (for
    ``grad_median``, the median part's gap and that part)."""
    loss = max((abs(p - w) / abs(w), f"step {i + 1}")
               for i, (p, w) in enumerate(zip(prog["losses"],
                                              want["losses"])))
    return {"loss": loss,
            "grad": worst_gap(prog["grad"], want["grad"]),
            "grad_median": median_gap(prog["grad"], want["grad"]),
            "change": worst_gap(prog["change"], want["change"],
                                moving_parts(want["grad"]))}


def initial_change(cfg: dict, seed: int, leaves: Dict[str, torch.Tensor]
                   ) -> Norms:
    """Each part's change from the weights made from ``seed`` (in the
    configuration's dtype, as both sides started from them), one leaf at
    a time."""
    out: Norms = {}
    for leaf in weights.layout(cfg):
        t = leaves[leaf[0]]
        w0 = weights.make_leaf(seed, leaf, t.device, weights.dtype_of(cfg),
                               cfg)
        out.update(part_norms(leaf[0], t.float() - w0.float()))
        del w0
    return out


def reference_train(cfg: dict, mix: dict, seed: int, device, prec=ref.Exact
                    ) -> dict:
    """The reference's losses, first clipped gradient norms and changes
    over the mix's ``check_steps``, in fp32 from the seed's weights."""
    ref.exact_matmuls()
    w = {leaf[0]: weights.make_leaf(seed, leaf, device,
                                    weights.dtype_of(cfg), cfg).float()
         for leaf in weights.layout(cfg)}
    for t in w.values():
        t.requires_grad_(True)
    opt = ref.AdamW(mix["adamw"], w)
    n_micro = mix["microbatches"]
    losses, grad = [], None
    for step in range(mix["check_steps"]):
        x, y = (torch.from_numpy(a).to(device)
                for a in traffic.train_rows(mix, cfg["vocab_size"], seed,
                                            step))
        total, g = 0.0, None
        for xm, ym in zip(x.chunk(n_micro), y.chunk(n_micro)):
            loss = ref.loss(cfg, w, xm, ym, prec) / n_micro
            gm = torch.autograd.grad(loss, list(w.values()))
            g = list(gm) if g is None else [a.add_(b) for a, b in zip(g, gm)]
            total += float(loss.detach())
            del gm
        losses.append(total)
        g = opt.clipped(dict(zip(w, g)))
        if step == 0:
            grad = {}
            for k, t in g.items():
                grad.update(part_norms(k, t))
        with torch.no_grad():
            opt.step(w, g)
        del g
    with torch.no_grad():
        change = initial_change(cfg, seed, w)
    return {"losses": losses, "grad": grad, "change": change}


def cache_sample(mix: dict, seed: int, prompts: traffic.Prompts
                 ) -> List[int]:
    """Requests whose cache is checked, fixed before the window: the
    first cycle's first longest prompt and ``check_caches`` more of that
    cycle, drawn from the seed."""
    import numpy as np
    n = len(prompts.lengths)
    longest = max(range(n), key=lambda i: (prompts.length(i), -i))
    rng = np.random.default_rng([int(seed), 1 << 42])
    return sorted({longest} | set(rng.choice(
        n, size=min(n, mix["check_caches"]), replace=False).tolist()))


def logits_sample(mix: dict, seed: int, served: int, cached: List[int]
                  ) -> List[int]:
    """Requests whose served token and logits are checked, among the
    ``served`` ones: the cache sample and ``check_requests`` more, drawn
    from the seed."""
    import numpy as np
    rng = np.random.default_rng([int(seed), 1 << 44])
    return sorted({r for r in cached if r < served} | set(rng.choice(
        served, size=min(served, mix["check_requests"]),
        replace=False).tolist()))


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def reference_serve(cfg: dict, mix: dict, seed: int, device, served: dict,
                    prec=ref.Exact) -> Dict[str, Tuple[float, str]]:
    """The serving numbers over ``served``: {request: (served token, the
    program's logits (V,), its per-layer [(k, v)] or None)}."""
    ref.exact_matmuls()
    w = {leaf[0]: weights.make_leaf(seed, leaf, device,
                                    weights.dtype_of(cfg), cfg).float()
         for leaf in weights.layout(cfg)}
    prompts = traffic.Prompts(mix, cfg["vocab_size"], seed)
    gap, lerr, kverr = (0.0, ""), (0.0, ""), (0.0, "")
    for i, (tok, logits, kv) in sorted(served.items()):
        ids = torch.from_numpy(prompts.ids(i)).to(device)
        want, want_kv = ref.prefill(cfg, w, ids, prec)
        gap = max(gap, (float(want.max() - want[tok]), f"request {i}"))
        lerr = max(lerr, (rel_err(logits, want), f"request {i}"))
        for layer, ((k, v), (wk, wv)) in enumerate(zip(kv or [], want_kv)):
            kverr = max(kverr, (rel_err(k, wk), f"request {i} layer {layer} k"),
                        (rel_err(v, wv), f"request {i} layer {layer} v"))
        del want, want_kv
    return {"token_gap": gap, "logits": lerr, "kv": kverr}


def control_serve_tokens(cfg: dict, mix: dict, seed: int, device,
                         requests: List[int], kv_requests: List[int]
                         ) -> Dict[int, tuple]:
    """The control put in the program's place: the reference in fp8 over
    the same prompts, as ``served`` for :func:`reference_serve`."""
    ref.exact_matmuls()
    w = {leaf[0]: weights.make_leaf(seed, leaf, device,
                                    weights.dtype_of(cfg), cfg).float()
         for leaf in weights.layout(cfg)}
    prompts = traffic.Prompts(mix, cfg["vocab_size"], seed)
    out = {}
    for i in requests:
        ids = torch.from_numpy(prompts.ids(i)).to(device)
        logits, kv = ref.prefill(cfg, w, ids, ref.FP8)
        out[i] = (int(logits.argmax()), logits,
                  kv if i in kv_requests else None)
    return out


def verdict(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, list]]:
    """(every number the cell's limits name within its limit and at least
    one named, {name: [number, limit, where]}).  A number the limits do
    not name is shown with the limit None and not compared."""
    table = {k: [v, limits.get(k), at] for k, (v, at) in numbers.items()}
    held = [(v, lim) for v, lim, _ in table.values() if lim is not None]
    ok = bool(held) and all(v == v and v <= lim for v, lim in held)
    return ok, table
