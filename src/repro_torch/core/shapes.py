"""Shape buckets: sequence length as a first-class scheduling dimension.

Every tenant in the original stack was a fixed-shape vision/audio graph,
so occupancy (`which tenants run together`) was the only key the
:class:`~repro.core.deploy.PlanStore` needed.  Autoregressive LM tenants
break that: a prefill round over 64 tokens and a decode round over 1
token are the *same tenant* with order-of-magnitude different compute,
and a plan compiled for one mis-prices the other.

This module supplies the vocabulary the compile-and-serve stack keys on:

  * :class:`ShapeBucketSpec` — one tenant's power-of-two sequence-length
    buckets plus the graph builder that materializes the tenant's IR at
    a given bucket (``make_graph(seq)``).  Raw request lengths round up
    to the nearest bucket (``bucket_for``), so the number of distinct
    compiled shapes stays logarithmic in the max sequence length — the
    standard continuous-batching bucketing trick, applied at the
    co-schedule level.
  * :class:`PlanKey` — a point on the **product lattice** (occupancy x
    per-tenant bucket vector) the :class:`~repro.core.deploy.PlanStore`
    is keyed by.  Keys are *canonical*: tenants at their default bucket
    are omitted, so a key with no non-default buckets collapses to the
    bare occupancy ``frozenset`` — bitwise the pre-shape key, which is
    what keeps every fixed-shape session's store behaviour (and its
    test surface) unchanged.
  * :func:`make_plan_key` / :func:`key_parts` / :func:`key_distance` —
    the canonicalization and product-lattice Hamming distance used by
    the store's nearest-neighbor warm-start and the background
    compiler's lattice prefetcher.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, FrozenSet, Iterable, Mapping, Optional,
                    Sequence, Tuple, Union)


def pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    """All powers of two in ``[lo, hi]`` (inclusive), ascending — the
    standard bucket ladder: ``pow2_buckets(1, 64) == (1, 2, 4, ..., 64)``.
    """
    if lo < 1 or hi < lo:
        raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
    out = []
    b = 1
    while b <= hi:
        if b >= lo:
            out.append(b)
        b *= 2
    if not out:
        raise ValueError(f"no power of two in [{lo}, {hi}]")
    return tuple(out)


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class ShapeBucketSpec:
    """One tenant's sequence-length bucket set.

    ``buckets`` must be strictly ascending powers of two (a decode
    bucket of 1 is a power of two).  ``make_graph(seq)`` builds the
    tenant's IR graph at sequence length ``seq`` — it is only ever
    called with members of ``buckets``, and the graph it returns at
    ``default`` must be the graph registered in the session's
    ``CompileRequest.graphs`` (the session trusts this identity and
    never rebuilds the default bucket).  ``default`` is the bucket the
    request-level graph was built at; it defaults to ``max(buckets)``
    (the prefill-heaviest shape, which is also the most conservative
    reference for admission floors)."""
    buckets: Tuple[int, ...]
    make_graph: Callable[[int], object] = dataclasses.field(compare=False)
    default: Optional[int] = None

    def __post_init__(self) -> None:
        bs = tuple(int(b) for b in self.buckets)
        if not bs:
            raise ValueError("ShapeBucketSpec needs at least one bucket")
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"buckets must be strictly ascending: {bs}")
        for b in bs:
            if not _is_pow2(b):
                raise ValueError(f"bucket {b} is not a power of two")
        object.__setattr__(self, "buckets", bs)
        d = self.default if self.default is not None else bs[-1]
        if d not in bs:
            raise ValueError(f"default bucket {d} not in bucket set {bs}")
        object.__setattr__(self, "default", int(d))

    def bucket_for(self, seq_len: int) -> int:
        """Smallest bucket >= ``seq_len`` (clamped to the largest bucket
        — an over-long request runs at the max compiled shape)."""
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1: {seq_len}")
        for b in self.buckets:
            if b >= seq_len:
                return b
        return self.buckets[-1]

    def neighbors(self, bucket: int) -> Tuple[int, ...]:
        """Buckets one ladder step away from ``bucket`` (the lattice
        edges the prefetcher walks)."""
        if bucket not in self.buckets:
            raise ValueError(f"bucket {bucket} not in {self.buckets}")
        i = self.buckets.index(bucket)
        out = []
        if i > 0:
            out.append(self.buckets[i - 1])
        if i + 1 < len(self.buckets):
            out.append(self.buckets[i + 1])
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """One point on the (occupancy x bucket-vector) product lattice.

    ``buckets`` holds ``(tenant, bucket)`` pairs sorted by tenant, and
    only for tenants at a NON-default bucket — the canonical form, so a
    key with no entry equals the bare occupancy ``frozenset`` semantics
    (construct through :func:`make_plan_key`, which collapses that case
    to an actual ``frozenset`` and never returns a bucket-less
    ``PlanKey``)."""
    occupancy: FrozenSet[int]
    buckets: Tuple[Tuple[int, int], ...]

    def __post_init__(self) -> None:
        occ = frozenset(int(a) for a in self.occupancy)
        bks = tuple(sorted((int(t), int(b)) for t, b in self.buckets))
        if not bks:
            raise ValueError("bucket-less PlanKey: use a bare frozenset "
                             "(make_plan_key canonicalizes)")
        for t, b in bks:
            if t not in occ:
                raise ValueError(f"bucketed tenant {t} not in occupancy "
                                 f"{sorted(occ)}")
            if b < 1:
                raise ValueError(f"bucket must be >= 1: {b}")
        if len({t for t, _ in bks}) != len(bks):
            raise ValueError(f"duplicate tenant in buckets: {bks}")
        object.__setattr__(self, "occupancy", occ)
        object.__setattr__(self, "buckets", bks)

    def bucket_of(self, tenant: int) -> Optional[int]:
        """The non-default bucket of ``tenant``, or ``None`` (default)."""
        return dict(self.buckets).get(tenant)

    def __repr__(self) -> str:
        bk = ",".join(f"t{t}@{b}" for t, b in self.buckets)
        return f"PlanKey({sorted(self.occupancy)}|{bk})"


# a store key: bare occupancy (all buckets default) or a product point
StoreKey = Union[FrozenSet[int], PlanKey]


def make_plan_key(active: Iterable[int],
                  buckets: Optional[Mapping[int, int]] = None) -> StoreKey:
    """Canonical store key for ``active`` at the given non-default
    ``buckets`` (tenant -> bucket): a bare ``frozenset`` when ``buckets``
    is empty (the fixed-shape / all-default case), a :class:`PlanKey`
    otherwise.  Callers must pre-filter default buckets out — the
    session's ``plan_key`` does (this function has no spec context)."""
    occ = frozenset(int(a) for a in active)
    if not buckets:
        return occ
    return PlanKey(occ, tuple(sorted((int(t), int(b))
                                     for t, b in buckets.items())))


def key_parts(key: StoreKey) -> Tuple[FrozenSet[int], Dict[int, int]]:
    """Decompose a store key into ``(occupancy, non-default buckets)``."""
    if isinstance(key, PlanKey):
        return key.occupancy, dict(key.buckets)
    return frozenset(key), {}


def key_occupancy(key: StoreKey) -> FrozenSet[int]:
    return key.occupancy if isinstance(key, PlanKey) else frozenset(key)


def key_sort(key: StoreKey) -> tuple:
    """Deterministic total order over mixed bare/bucketed keys: by
    occupancy size, then members, then bucket vector (bare keys sort
    before any bucketed key at the same occupancy)."""
    occ, bks = key_parts(key)
    return (len(occ), sorted(occ), sorted(bks.items()))


def key_distance(a: StoreKey, b: StoreKey) -> int:
    """Hamming distance on the product lattice: the occupancy symmetric
    difference plus, over the shared tenants, how many run at different
    buckets (an omitted entry is the default bucket — comparing absent
    vs absent is distance 0 without knowing the default's value)."""
    occ_a, bk_a = key_parts(a)
    occ_b, bk_b = key_parts(b)
    d = len(occ_a ^ occ_b)
    for t in occ_a & occ_b:
        if bk_a.get(t) != bk_b.get(t):
            d += 1
    return d


def remap_key(key: StoreKey, index_map: Mapping[int, int]) -> StoreKey:
    """The same lattice point under a tenant re-indexing (the fleet's
    solution-sidecar transplant between sessions whose tenant orders
    differ).  Every member of the occupancy must be mapped."""
    occ, bks = key_parts(key)
    new_occ = [index_map[t] for t in occ]
    new_bks = {index_map[t]: b for t, b in bks.items()}
    return make_plan_key(new_occ, new_bks)


def describe_key(key: StoreKey) -> str:
    """Human-readable key for telemetry / analyzer contexts."""
    occ, bks = key_parts(key)
    if not bks:
        return str(sorted(occ))
    return (f"{sorted(occ)} @ "
            + ",".join(f"t{t}:{b}" for t, b in sorted(bks.items())))
