"""The port's mesh planner (``core/meshplan.py``) against the JAX
package's.

Twins of tests/test_meshplan.py; then, with the port's lane constants
(an H100's) patched to the JAX package's (a TPU v5e's), the CP's choice,
notes and lane seconds for every arch at model 1, 2, 4 and 16 equal
JAX's, and ``plan_model``'s rules and hints over the 16 x 16 and
2 x 16 x 16 production meshes equal JAX's for every (arch, shape) cell:
the JAX side reads a stand-in with ``axis_names`` and ``devices.shape``,
the port a ``DeviceMesh`` over a ``fake`` process group of 256 or 512
ranks.  Every SMOKE param leaf's placements are those of JAX's
``spec_for``, and the port's pytree paths spell JAX's ``_path_str`` on
every param and cache leaf (stacked ``blocks/<u>/...`` and
``slots/<u>/...`` included).
"""

import jax
import pytest

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES, applicable
from repro.core import meshplan as jmp
from repro_torch.configs import registry as treg
from repro_torch.core import meshplan as tmp
from repro_torch.core.pytree import leaves_with_path

LANES = ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "ICI_EFF")


class _JaxMesh:
    """What the JAX planner reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes

        class devices:
            pass
        devices.shape = shape
        self.devices = devices


class _Grid:
    """What the port's planner reads of a mesh, without a process group."""

    def __init__(self, shape, axes):
        self.mesh_dim_names, self.shape = axes, shape


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def v5e_lanes(monkeypatch):
    for name in LANES:
        monkeypatch.setattr(tmp, name, getattr(jmp, name))


# ---------------------------------------------------------------- twins


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_strategy_cp_runs_and_is_feasible(arch):
    cfg = treg.get_config(arch)
    chosen, lanes, notes = tmp._choose(16, cfg, 4096 * 256, 16)
    assert set(chosen) == {"attention", "ffn", "vocab"}
    assert all(v >= 0 for v in lanes.values())


def test_moe_ep_divisibility_drives_strategy():
    """olmoe has 64 experts (divisible by 16 -> EP allowed); granite has 40
    (not divisible -> EP infeasible, the CP picks another strategy)."""
    olmoe = treg.get_config("olmoe-1b-7b")
    granite = treg.get_config("granite-moe-3b-a800m")
    ch_o, _, _ = tmp._choose(16, olmoe, 4096 * 256, 16)
    ch_g, _, notes_g = tmp._choose(16, granite, 4096 * 256, 16)
    assert ch_o["ffn"] in ("expert_parallel", "expert_ffn_tp")
    assert ch_g["ffn"] != "expert_parallel"
    assert any("infeasible" in n for n in notes_g)


def test_vocab_tp_requires_divisibility():
    """granite vocab 49155 is not divisible by 16: vocab_tp infeasible."""
    granite = treg.get_config("granite-moe-3b-a800m")
    ch, _, _ = tmp._choose(16, granite, 4096 * 256, 16)
    assert ch["vocab"] == "dp_replicated"


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_rules_cover_every_param(arch):
    cfg = treg.get_smoke_config(arch)
    mesh = _Grid((1, 1), ("data", "model"))
    plan = tmp.plan_model(cfg, mesh, "train", 8, 64)
    params = treg.param_specs(cfg)
    sh = tmp.tree_shardings(plan, mesh, params)
    got = dict(leaves_with_path(sh))
    for path, leaf in leaves_with_path(params):
        s = got[path]
        assert isinstance(s, tmp.Sharding)
        assert len(s.spec) <= leaf.dim(), (path, s.spec, leaf.shape)


def test_plan_notes_record_infeasibilities():
    granite = treg.get_config("granite-moe-3b-a800m")
    plan = tmp.plan_model(granite, _Grid((1, 1), ("data", "model")),
                          "train", 8, 64)
    assert isinstance(plan.notes, list)


# ------------------------------------------------ against the JAX planner


@pytest.mark.parametrize("model_par", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_choose_matches_jax_with_its_lanes(v5e_lanes, arch, model_par):
    """The same CP, classes, candidates and feasibility: with the v5e's
    lane constants the port picks what JAX picks, notes what it notes,
    and predicts its lane seconds."""
    tokens, dp = 4096 * 256, 256 // model_par
    cj, lj, nj = jmp._choose(model_par, jreg.get_config(arch), tokens, dp)
    ct, lt, nt = tmp._choose(model_par, treg.get_config(arch), tokens, dp)
    assert ct == cj and nt == nj
    assert set(lt) == set(lj) == {"mxu", "hbm", "ici"}
    for lane in lj:
        assert lt[lane] == pytest.approx(lj[lane], rel=1e-12, abs=0.0)


def test_lane_constants_are_an_h100s():
    """989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a
    direction (NVIDIA's H100 SXM data sheet)."""
    assert (tmp.PEAK_FLOPS, tmp.HBM_BW, tmp.ICI_BW) == (989e12, 3.35e12,
                                                         450e9)
    assert tmp.ICI_EFF == tmp.ICI_BW


@pytest.fixture
def fake_group():
    """``make(world)``: a ``fake`` process group of ``world`` ranks, torn
    down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import init_fake_group
    yield init_fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _cells():
    for arch in jreg.ARCH_IDS:
        for name, shape in SHAPES.items():
            if applicable(jreg.get_config(arch), shape)[0]:
                yield arch, shape


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_plan_model_matches_jax(v5e_lanes, fake_group, mesh_name):
    """Every live cell's rules (pattern and spec), hints, strategy, data
    axes and notes equal JAX's; the port reads a DeviceMesh over a fake
    group of the mesh's size."""
    from repro_torch.launch.mesh import make_production_mesh
    shape, axes = MESHES[mesh_name]
    multi = len(shape) == 3
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    assert tmp.mesh_axes(mesh) == dict(zip(axes, shape))
    jmesh = _JaxMesh(shape, axes)
    for arch, sh in _cells():
        args = (sh.kind, sh.global_batch, sh.seq_len)
        jp = jmp.plan_model(jreg.get_config(arch), jmesh, *args)
        tp = tmp.plan_model(treg.get_config(arch), mesh, *args)
        what = f"{arch} {sh.name}"
        assert tp.strategy == jp.strategy, what
        assert [(p, tuple(s)) for p, s in tp.rules] == \
            [(p, tuple(s)) for p, s in jp.rules], what
        assert {k: v if v is True else tuple(v)
                for k, v in tp.hints.items()} == \
            {k: v if v is True else tuple(v)
             for k, v in jp.hints.items()}, what
        assert (tp.data_axes, tp.model_axis, tp.notes) == \
            (jp.data_axes, jp.model_axis, jp.notes), what
        for lane, v in jp.lane_seconds.items():
            assert tp.lane_seconds[lane] == pytest.approx(v, rel=1e-12)


def _jax_placements(spec, axes):
    """The DTensor placements a JAX spec means on a mesh of ``axes``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axes:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


FORCE = {"dense": "ffn_tp", "vlm": "ffn_tp", "audio": "ffn_tp",
         "ssm": "ffn_tp", "hybrid": "ffn_tp", "moe": "expert_ffn_tp"}


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_smoke_param_placements_are_jax_spec_for(v5e_lanes, arch):
    """Each SMOKE param leaf's placements over the 2 x 16 x 16 mesh, under
    the CP's plan (the v5e's lanes on both sides) and under
    tensor-parallel strategies forced alike, are those of JAX's
    ``spec_for`` (a ("pod", "data") entry shards one dim over two mesh
    dims)."""
    cj, ct = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    shape, axes = MESHES["2x16x16"]
    grid = _Grid(shape, axes)
    jparams = jreg.param_specs(cj)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    force = {"attention": "head_tp", "ffn": FORCE[ct.family],
             "vocab": "vocab_tp"}
    for override in (None, force):
        jp = jmp.plan_model(cj, _JaxMesh(shape, axes), "train", 64, 32,
                            override=override)
        tp = tmp.plan_model(ct, grid, "train", 64, 32, override=override)
        got = dict(leaves_with_path(tmp.tree_shardings(
            tp, grid, treg.param_specs(ct))))
        for path, leaf in jleaves:
            ps = jmp._path_str(path)
            want = jp.spec_for(ps, len(leaf.shape))
            s = got[tuple(ps.split("/"))]
            assert tuple(s.spec) == tuple(want), ps
            assert s.placements == _jax_placements(want, axes), ps


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_paths_are_jax_path_str(arch):
    """Param and cache leaves: the port's paths, in its leaf order, are
    JAX's ``_path_str`` in ``tree_flatten`` order, stacked slots too; the
    meta specs have JAX's shapes and dtypes."""
    cj, ct = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    trees = [(jreg.param_specs(cj), treg.param_specs(ct))]
    if cj.has_decode:
        trees.append((jreg.cache_specs(cj, 2, 16), treg.cache_specs(ct, 2,
                                                                    16)))
    for jtree, ttree in trees:
        jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        tl = list(leaves_with_path(ttree))
        assert [jmp._path_str(p) for p, _ in jl] == \
            [tmp.path_str(p) for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            assert b.device.type == "meta"
    assert any(p[0] == "blocks" for p, _ in leaves_with_path(
        treg.param_specs(ct)))


def test_input_specs_are_jax_shapes():
    """``batch_input_specs`` and ``decode_input_specs``: JAX's shapes and
    dtypes, meta tensors."""
    for arch in treg.ARCH_IDS:
        cj, ct = jreg.get_config(arch), treg.get_config(arch)
        for jt, tt in ((jreg.batch_input_specs(cj, 4, 32),
                        treg.batch_input_specs(ct, 4, 32)),
                       (jreg.decode_input_specs(cj, 4),
                        treg.decode_input_specs(ct, 4))):
            assert set(jt) == set(tt)
            for k in jt:
                assert tuple(jt[k].shape) == tuple(tt[k].shape)
                assert str(jt[k].dtype) == str(tt[k].dtype).replace(
                    "torch.", "")
                assert tt[k].device.type == "meta"


def test_spec_placements_and_pickling():
    """A tuple entry shards one dim over two mesh dims; a Spec compares
    with a JAX PartitionSpec entry for entry and survives pickling."""
    import pickle

    from jax.sharding import PartitionSpec as P
    from torch.distributed.tensor import Replicate, Shard
    grid = _Grid((2, 16, 16), ("pod", "data", "model"))
    s = tmp.Spec(("pod", "data"), None, "model")
    assert tmp.placements(s, grid) == (Shard(0), Shard(0), Shard(2))
    assert tmp.placements(tmp.Spec(), grid) == (Replicate(),) * 3
    assert tuple(s) == tuple(P(("pod", "data"), None, "model"))
    assert pickle.loads(pickle.dumps(s)) == s
    assert type(pickle.loads(pickle.dumps(s))) is tmp.Spec
    with pytest.raises(ValueError):
        tmp.placements(tmp.Spec("model", "model"), grid)


def test_mesh_needs_a_matching_process_group(fake_group):
    """``launch/mesh.py`` builds nothing at import, raises with no process
    group and when the group's size is not the mesh's."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_host_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_production_mesh(device="cpu")
    fake_group(4)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        M.make_production_mesh(device="cpu")
    m = M.make_host_mesh(2, device="cpu")
    assert (m.mesh_dim_names, tuple(m.shape)) == (("data", "model"), (2, 2))
    m = M.make_mesh((4, 1), ("data", "model"), device="cpu")
    assert tuple(m.shape) == (4, 1)
