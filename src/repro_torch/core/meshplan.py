"""MeshPartitioner: MATCHA's tile-centric CP mapping, adapted to a mesh of
GPUs.

The paper assigns integer tile counts of each operator to heterogeneous
*devices* to minimize a makespan over per-device loads (Eqs. 1-2).  On a
homogeneous mesh of cards the heterogeneity moves into the *lanes* of each
card: tensor-core compute, HBM bandwidth and the interconnect's
collectives each have their own "alpha" (inverse peak).  The partitioner
keeps the JAX package's CP structure:

  * "patterns"  -> candidate sharding strategies per tensor class
                   (head-TP, ffn-TP, expert-parallel, DP);
  * "tiles"     -> the shardable extent (heads / ffn columns / experts)
                   split across the `model` axis;
  * "devices"   -> the three lanes (keys ``mxu``, ``hbm``, ``ici``, the JAX
                   package's names); the objective is the max over lanes
                   of the summed per-step occupancy in seconds;
  * Eq. (1)     -> each class selects exactly one strategy (coverage);
                   divisibility constraints play the role of match
                   feasibility (a 40-expert MoE cannot take EP=16, so the
                   CP routes it to ffn-TP instead: granite vs olmoe).

The output is a ShardingPlan: param-path -> :class:`Spec` rules plus
activation/cache hints.  A :class:`Spec` is the port's PartitionSpec (per
tensor dim a mesh axis name, a tuple of names, or None), and
:func:`placements` turns one into DTensor placements on a
``DeviceMesh``; ``launch/{dryrun,train}`` place params, optimizer state,
batches and caches by them, and ``core/hints.py`` redistributes the
interior tensors the plan names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import cpsolver
from repro_torch.core.pytree import LeafTuple, tree_map, tree_map_with_path
from repro_torch.models.config import ModelConfig

# One H100 SXM's lanes (NVIDIA's H100 data sheet, SXM part, dense rates:
# the peaks PERF.md's bounds use)
PEAK_FLOPS = 989e12          # bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, bytes/s
ICI_BW = 450e9               # NVLink 4, bytes/s a direction
# The collective bandwidth the planner prices: NVSwitch joins every card to
# every other, and a ring collective over it sends and receives at a
# card's full NVLink rate in each direction at once.
ICI_EFF = ICI_BW

# perf-iteration knob: decode cache writes via scatter instead of select
# (the port writes its cache in place either way; the hint is still read)
DECODE_SCATTER_UPDATE = False


class Spec(LeafTuple):
    """The port's PartitionSpec: one entry a tensor dim, each a mesh axis
    name, a tuple of names (the dim sharded over several mesh axes, in
    order), or None (not sharded).  Trailing dims past its length are not
    sharded.  A tuple, so it compares with a JAX ``PartitionSpec`` entry
    for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):                    # pickle, copy
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (``mesh_dim_names``,
    ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that entry ``i`` names (a tuple entry shards dim ``i`` over
    each of its mesh dims), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"{spec!r} names mesh axis {name!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh (JAX's ``NamedSharding``): its spec and
    the DTensor placements the spec gives on ``mesh``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)


def distribute(tree, shardings):
    """``tree``'s tensors as DTensors laid out by ``shardings`` (a matching
    tree of :class:`Sharding`): a plain tensor from the full tensor, which
    every rank holds alike; a DTensor redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, s):
        if isinstance(t, DTensor):
            return t.redistribute(s.mesh, s.placements)
        return distribute_tensor(t, s.mesh, s.placements)
    return tree_map(place, tree, shardings)


@dataclasses.dataclass
class ShardingPlan:
    arch: str
    mode: str                                    # train | prefill | decode
    rules: List[Tuple[str, Spec]]                # path regex -> spec
    data_axes: Tuple[str, ...]                   # batch sharding axes
    model_axis: str
    strategy: Dict[str, str]                     # class -> chosen strategy
    lane_seconds: Dict[str, float]               # CP's predicted occupancy
    notes: List[str] = dataclasses.field(default_factory=list)
    # interior-tensor sharding hints (core.hints), e.g. MoE dispatch
    hints: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def spec_for(self, path: str, ndim: Optional[int] = None) -> Spec:
        spec = Spec()
        for pat, s in self.rules:
            if re.search(pat, path):
                spec = s
                break
        # stacked layer slots carry a leading (replicated) G axis
        if ndim is not None and path.startswith("blocks/") \
                and ndim == len(spec) + 1:
            spec = Spec(None, *spec)
        return spec

    def sharding_for(self, mesh, path: str,
                     ndim: Optional[int] = None) -> Sharding:
        return Sharding(mesh, self.spec_for(path, ndim))


def path_str(path: Tuple[str, ...]) -> str:
    """A leaf's path from :func:`~repro_torch.core.pytree.leaves_with_path`
    as the JAX package's ``_path_str`` spells it: keys and indices joined
    by ``/``."""
    return "/".join(path)


def map_with_path(fn, tree):
    """``fn(path_string, leaf)`` over ``tree``'s leaves, keeping its
    structure (``jax.tree_util.tree_map_with_path`` with the JAX package's
    path strings)."""
    return tree_map_with_path(lambda p, leaf: fn(path_str(p), leaf), tree)


def tree_shardings(plan: ShardingPlan, mesh, tree):
    """Matching tree of :class:`Sharding` for a params tree."""
    return map_with_path(
        lambda ps, leaf: plan.sharding_for(mesh, ps, leaf.dim()), tree)


# ---------------------------------------------------------------------------
# Strategy candidates and their lane costs
# ---------------------------------------------------------------------------


def _choose(model_par: int, cfg: ModelConfig, tokens_per_step: int,
            dp: int) -> Tuple[Dict[str, str], Dict[str, float], List[str]]:
    """CP selection of one strategy per class.  Costs are per-step lane
    occupancy in seconds for the dominant matmuls; constants cancel in the
    argmax so only *relative* structure matters, but we keep real units."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, dh = max(cfg.n_heads, 1), max(cfg.n_kv, 1), cfg.head_dim_
    E = cfg.n_experts
    notes: List[str] = []

    classes: Dict[str, List[Tuple[str, Dict[str, float], bool]]] = {}

    def flops_s(fl):
        return fl / PEAK_FLOPS

    def mem_s(by):
        return by / HBM_BW

    def ici_s(by):
        return by / ICI_EFF

    t = tokens_per_step / max(dp, 1)          # tokens per data shard
    # HBM traffic is params + *activations*: a replicated-compute strategy
    # re-reads/writes the full per-data-shard activations on every card of
    # the model axis, while TP touches 1/model_par of them.
    act_bytes = 8 * t * D * 2                 # ~8 tensor touches / layer
    # --- attention projections class ---
    attn_flops = 2 * t * D * (H * dh + 2 * KV * dh + H * dh)
    cands = []
    if H % model_par == 0 and (KV % model_par == 0 or KV <= model_par):
        # Megatron head-TP: qkv col-sharded, o row-sharded; one all-reduce
        # of the block output per layer (fused with the MLP's in practice)
        kv_rep = max(model_par // KV, 1)
        ar_bytes = 2 * t * D * 2            # fwd ar + bwd ar (bf16)
        cands.append(("head_tp", {
            "mxu": flops_s(attn_flops / model_par),
            "hbm": mem_s((2 * (D * (H + 2 * KV * kv_rep) * dh)
                          + act_bytes) / model_par),
            "ici": ici_s(ar_bytes),
        }, True))
    cands.append(("dp_replicated", {
        "mxu": flops_s(attn_flops),
        "hbm": mem_s(2 * D * (H + 2 * KV) * dh + act_bytes),
        "ici": 0.0,
    }, True))
    classes["attention"] = cands

    # --- FFN class ---
    if cfg.family == "moe":
        ffn_flops = 2 * t * cfg.top_k * 3 * D * F
        cands = []
        if E % model_par == 0:
            a2a = 2 * t * cfg.top_k * D * 2 * 2   # dispatch+combine, fwd+bwd
            cands.append(("expert_parallel", {
                "mxu": flops_s(ffn_flops / model_par),
                "hbm": mem_s(2 * E * 3 * D * F / model_par),
                "ici": ici_s(a2a / 4),             # a2a moves 1/axis bytes
            }, True))
        if F % model_par == 0 or F >= model_par:
            cands.append(("expert_ffn_tp", {
                "mxu": flops_s(ffn_flops / model_par),
                "hbm": mem_s(2 * E * 3 * D * F / model_par),
                "ici": ici_s(2 * t * D * 2 * 2),
            }, True))
        cands.append(("dp_replicated", {
            "mxu": flops_s(ffn_flops),
            "hbm": mem_s(2 * E * 3 * D * F),
            "ici": 0.0,
        }, True))
        classes["ffn"] = cands
    else:
        ffn_flops = 2 * t * 3 * D * F
        classes["ffn"] = [
            ("ffn_tp", {
                "mxu": flops_s(ffn_flops / model_par),
                "hbm": mem_s(2 * 3 * D * F / model_par),
                "ici": ici_s(2 * t * D * 2),
            }, F % model_par == 0),
            ("dp_replicated", {
                "mxu": flops_s(ffn_flops),
                "hbm": mem_s(2 * 3 * D * F),
                "ici": 0.0,
            }, True),
        ]

    # --- vocab / embedding class ---
    emb_flops = 2 * t * D * V
    classes["vocab"] = [
        ("vocab_tp", {
            "mxu": flops_s(emb_flops / model_par),
            "hbm": mem_s(2 * 2 * V * D / model_par),
            # only the per-token max/sum scalars of a vocab-sharded CE
            # cross the interconnect
            "ici": ici_s(t * 8),
        }, V % model_par == 0),
        ("dp_replicated", {
            "mxu": flops_s(emb_flops),
            "hbm": mem_s(2 * 2 * V * D),
            "ici": 0.0,
        }, True),
    ]

    # --- CP: pick one strategy per class, minimize max lane load ---
    model = cpsolver.CpModel()
    yvars: Dict[Tuple[str, str], int] = {}
    for cname, cands in classes.items():
        feas = [(s, costs) for (s, costs, ok) in cands if ok]
        ys = []
        for s, costs in feas:
            y = model.new_int(0, 1, f"{cname}:{s}")
            yvars[(cname, s)] = y
            ys.append(y)
        model.add_eq({y: 1.0 for y in ys}, -1.0)    # exactly one
    for lane in ("mxu", "hbm", "ici"):
        load = {}
        for (cname, s), y in yvars.items():
            costs = dict(next(c for (nm, c, ok) in classes[cname]
                              if nm == s))
            load[y] = load.get(y, 0.0) + costs[lane]
        model.add_load(load)
    sol = model.solve(node_limit=20_000, time_budget_s=2.0)

    chosen: Dict[str, str] = {}
    for (cname, s), y in yvars.items():
        if sol.values[y] == 1:
            chosen[cname] = s
    lanes = {"mxu": 0.0, "hbm": 0.0, "ici": 0.0}
    for cname, s in chosen.items():
        costs = next(c for (nm, c, ok) in classes[cname] if nm == s)
        for lane in lanes:
            lanes[lane] += costs[lane]
    for cname, cands in classes.items():
        infeas = {nm for (nm, _, ok) in cands if not ok}
        if infeas:
            notes.append(f"{cname}: {sorted(infeas)} infeasible at "
                         f"model={model_par} -> {chosen[cname]}")
    return chosen, lanes, notes


# ---------------------------------------------------------------------------
# Rule synthesis
# ---------------------------------------------------------------------------


def plan_model(cfg: ModelConfig, mesh, mode: str,
               global_batch: int, seq_len: int,
               override: Optional[Dict[str, str]] = None) -> ShardingPlan:
    """``mesh``: a ``DeviceMesh`` with axes among ``pod``, ``data`` and
    ``model``.  ``override``: force strategies (class -> name) past the
    CP, for hypothesis testing."""
    axes = mesh_axes(mesh)
    model_axis = "model"
    model_par = axes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp = 1
    for a in data_axes:
        dp *= axes[a]
    tokens = global_batch * (seq_len if mode == "train" else 1)

    chosen, lanes, notes = _choose(model_par, cfg, tokens, dp)
    if override:
        chosen.update(override)
        notes.append(f"strategy override: {override}")
    M = model_axis
    dspec = data_axes if len(data_axes) > 1 else (data_axes[0]
                                                  if data_axes else None)

    rules: List[Tuple[str, Spec]] = []
    # ---- attention ----
    if chosen.get("attention") == "head_tp":
        rules += [
            (r"attn/w[qkv]/w$", Spec(None, M)),
            (r"attn/wo/w$", Spec(M, None)),
            (r"attn/[qk]_norm/g$", Spec()),
        ]
    else:
        rules += [(r"attn/", Spec())]
        notes.append("attention: replicated (DP only)")
    # ---- FFN ----
    if cfg.family == "moe":
        if chosen.get("ffn") == "expert_parallel":
            rules += [
                (r"moe/w_(gate|up)$", Spec(M, None, None)),
                (r"moe/w_down$", Spec(M, None, None)),
                (r"moe/router/w$", Spec()),
            ]
        elif chosen.get("ffn") == "expert_ffn_tp":
            rules += [
                (r"moe/w_(gate|up)$", Spec(None, None, M)),
                (r"moe/w_down$", Spec(None, M, None)),
                (r"moe/router/w$", Spec()),
            ]
        else:
            rules += [(r"moe/", Spec())]
    else:
        if chosen.get("ffn") == "ffn_tp":
            rules += [
                (r"(mlp|cm)/w_?(gate|up|k)?(/w)?$", Spec(None, M)),
                (r"(mlp|cm)/w_?(down|v)(/w)?$", Spec(M, None)),
            ]
        else:
            rules += [(r"(mlp|cm)/", Spec())]
    # ---- rwkv time-mix / rglru recurrent projections: model-shard the
    # channel dimension (the diagonal recurrence is channel-parallel) ----
    rules += [
        (r"tm/w[rkvg]/w$", Spec(None, M)),
        (r"tm/wo/w$", Spec(M, None)),
        (r"tm/(w0|u|mu_.*)$", Spec()),
        (r"tm/w_lora_[ab]/w$", Spec()),
        (r"rec/w_(gate|x)/w$", Spec(None, M)),
        (r"rec/w(a|i)/w$", Spec(None, M)),
        (r"rec/(lam|conv)$", Spec()),
        (r"rec/w_out/w$", Spec(M, None)),
    ]
    # ---- vocab ----
    if chosen.get("vocab") == "vocab_tp":
        rules += [
            (r"embed/table$", Spec(M, None)),
            (r"head/w$", Spec(None, M)),
        ]
    else:
        rules += [(r"embed/table$", Spec()), (r"head/w$", Spec())]
    # ---- norms & defaults ----
    rules += [(r"ln", Spec()), (r".", Spec())]

    # ---- interior-tensor hints (enforced via core.hints) ----
    hints: Dict[str, Any] = {}
    if cfg.family == "moe":
        # dispatch buffers are (E, B*C, D); hidden is (E, B*C, F)
        if chosen.get("ffn") == "expert_parallel":
            hints["moe_dispatch"] = Spec(M, None, None)
            hints["moe_hidden"] = Spec(M, None, None)
            hints["moe_out"] = Spec(M, None, None)
        elif chosen.get("ffn") == "expert_ffn_tp":
            hints["moe_dispatch"] = Spec(None, dspec, None)
            hints["moe_hidden"] = Spec(None, dspec, M)
            hints["moe_out"] = Spec(None, dspec, None)
    if mode == "decode":
        # keep the updated KV cache in its planned layout instead of
        # re-gathering it every step (caches are (B,S,KV,Dh))
        batch_ok = global_batch % max(dp, 1) == 0 and global_batch >= dp
        bd = dspec if batch_ok else None
        if DECODE_SCATTER_UPDATE:
            hints["decode_scatter_update"] = True
        hints["decode_cache"] = Spec(bd, M, None, None)
        hints["decode_logits"] = Spec(bd, None, None, M)
        # with a 1-token batch, pin the projection outputs to stay
        # model-sharded rather than gathering the TP weights
        if chosen.get("attention") == "head_tp" \
                and cfg.n_heads % model_par == 0:
            hints["decode_heads"] = Spec(bd, None, M, None)
        if chosen.get("ffn") == "ffn_tp" and cfg.d_ff % model_par == 0:
            hints["ffn_hidden"] = Spec(bd, None, M)

    return ShardingPlan(arch=cfg.name, mode=mode, rules=rules,
                        data_axes=data_axes, model_axis=model_axis,
                        strategy=chosen, lane_seconds=lanes, notes=notes,
                        hints=hints)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def _data_entry(plan: ShardingPlan):
    return plan.data_axes if len(plan.data_axes) != 1 else plan.data_axes[0]


def batch_spec(plan: ShardingPlan) -> Spec:
    return Spec(_data_entry(plan))


def batch_shardings(plan: ShardingPlan, mesh, batch_tree):
    """Shardings of a batch tree: the leading (batch) dim over the data
    axes."""
    spec = batch_spec(plan)
    return tree_map(lambda leaf: Sharding(mesh, spec), batch_tree)


def cache_shardings(plan: ShardingPlan, mesh, cache_tree,
                    global_batch: int):
    """KV caches: shard batch over the data axes; when the batch is too
    small (long_500k has B=1) shard the *sequence* axis of attention caches
    over `model` (a seq-sharded partial softmax + reduce: ring-style
    decode)."""
    axes = mesh_axes(mesh)
    dp = 1
    for a in plan.data_axes:
        dp *= axes[a]
    d = _data_entry(plan)
    M = plan.model_axis
    batch_ok = global_batch % max(dp, 1) == 0 and global_batch >= dp

    def spec(ps, leaf):
        nd = leaf.dim()
        # stacked slots carry a leading G axis: "slots/<u>/..."
        stacked = ps.startswith("slots/")
        lead = (None,) if stacked else ()
        eff = nd - len(lead)

        def mk(*axes_):
            return Spec(*(lead + axes_))

        if ps.endswith("pos"):
            return Spec(d if batch_ok else None)
        if eff >= 4 and (ps.endswith("/k") or ps.endswith("/v")):
            seq_ax = 1 if not stacked else 2
            seq_ok = leaf.shape[seq_ax] % axes.get(M, 1) == 0
            if batch_ok and seq_ok:
                # 2-D cache sharding: batch over data, sequence over model
                return mk(d, M, None, None)
            if batch_ok:
                return mk(d, None, None, None)
            if seq_ok:
                return mk(None, M, None, None)
            return mk(*((None,) * eff))
        if eff == 4 and "wkv" in ps:
            return mk(d if batch_ok else None, None, None, None)
        if eff >= 2 and batch_ok:
            return mk(*((d,) + (None,) * (eff - 1)))
        return mk(*((None,) * eff))
    return map_with_path(lambda ps, leaf: Sharding(mesh, spec(ps, leaf)),
                         cache_tree)
