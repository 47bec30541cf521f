"""The port's tile tuner (``repro_torch.kernels.autotune``), the twin of
``tests/test_autotune.py``: at the JAX test's shapes every pick is a
launch the port's wrappers make (K1: ``matmul.tile``'s block tile and a
split of ``matmul.splits``; K3: a key tile compiled for the head width),
its shared memory fits a block and its modelled time is positive; K1's
pick is ``matmul.plan``'s, by the one cost model both use; the tuned
shapes run through the port's plain versions on the CPU and agree with
the Pallas kernels in interpret mode on the same numpy-seeded inputs, at
the JAX test's tolerances; and the long-sequence property, which the card
gives in its own form (see ``test_long_seq_choice_is_not_memory_bound``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.kernels import autotune
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.matmul import matmul as mm

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DTYPES = {2: torch.bfloat16, 4: torch.float32}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("M,N,K", [(512, 512, 512), (4096, 1024, 8192),
                                   (256, 12288, 4096)])
def test_tune_matmul_valid(M, N, K, itemsize):
    t = autotune.tune_matmul(M, N, K, itemsize)
    assert t.route == "tile"
    tm, tn = mm.tile(t.route, M, N)
    assert (t.block_m, t.block_n) == (8 * tm, 16 * tn)
    assert (t.splits, t.block_k) in mm.splits(t.route, M, N, K)
    assert t.smem_bytes <= autotune.SMEM_LIMIT
    assert t.est_seconds > 0


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_matmul_pick_is_plans(sms):
    """Over decode, bucket and prefill shapes, both dtypes: the tuner's
    pick is ``plan``'s, and its time is ``cost``'s."""
    for M in (1, 2, 5, 8, 9, 32, 64, 512):
        for K in (128, 2560, 8960):
            for N in (48, 1280, 4480):
                for itemsize, dtype in DTYPES.items():
                    r = "gemv" if M <= mm.GEMV_MAX_M else "tile"
                    ranked = autotune.rank_matmul(M, N, K, itemsize, sms)
                    pick = ranked[0]
                    plan = mm.plan(r, M, N, K, sms, dtype)
                    assert (pick.route, (pick.splits, pick.block_k)) == \
                        (r, plan)
                    assert pick.est_seconds == mm.cost(r, M, N, sms, dtype,
                                                       plan)
                    assert [(t.splits, t.block_k) for t in ranked] == sorted(
                        mm.splits(r, M, N, K),
                        key=lambda s: mm.cost(r, M, N, sms, dtype, s))


def test_gemv_pick_holds_its_rows_and_chunk():
    t = autotune.tune_matmul(1, 4480, 8960, 4)
    assert t.route == "gemv" and t.block_m == 1 and t.block_n == 128
    assert t.block_k * t.block_m <= mm._GEMV_A_FLOATS
    assert t.smem_bytes == 4 * max(t.block_k, 8 * 128)


def test_split_argument_is_checked():
    a, b = torch.randn(64, 1280), torch.randn(1280, 256)
    want = a @ b
    for split in mm.splits("tile", 64, 256, 1280):
        torch.testing.assert_close(mm.matmul(a, b, split=split), want)
    with pytest.raises(ValueError, match="split"):
        mm.matmul(a, b, split=(3, 100))
    # a tile split whose chunk is no whole gemv step of 128 k rows
    assert (8, 160) in mm.splits("tile", 64, 256, 1280)
    with pytest.raises(ValueError, match="split"):
        mm.matmul(a[:1], b, split=(8, 160))


def test_tuned_matmul_runs_and_matches():
    """The twin of the JAX test: the port's pick through the plain version
    on the CPU, the JAX pick through the Pallas kernel in interpret mode,
    the same numpy-seeded inputs."""
    from repro.kernels.matmul.matmul import matmul_pallas
    M, N, K = 256, 256, 512
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    t = autotune.tune_matmul(M, N, K, itemsize=4)
    got = mm.matmul(torch.from_numpy(a), torch.from_numpy(b),
                    split=(t.splits, t.block_k))
    jt = jautotune.tune_matmul(M, N, K, itemsize=4)
    want = matmul_pallas(jnp.asarray(a), jnp.asarray(b), block_m=jt.block_m,
                         block_n=jt.block_n, block_k=jt.block_k,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("S,Dh", [(4096, 128), (32768, 128), (1024, 256)])
def test_tune_attention_valid(S, Dh):
    t = autotune.tune_flash_attention(S, Dh)
    assert t.block_q == fa.WGMMA_BLOCK_Q
    assert t.block_k in fa.WGMMA_BLOCK_K[Dh]
    assert t.smem_bytes <= autotune.SMEM_LIMIT
    assert t.est_seconds > 0
    assert [r.block_k for r in autotune.rank_flash_attention(S, Dh)] \
        == sorted(fa.WGMMA_BLOCK_K[Dh], key=lambda bk: next(
            r.est_seconds for r in autotune.rank_flash_attention(S, Dh)
            if r.block_k == bk))


def test_attention_instances_are_the_compiled_ones():
    """The wrapper's table of key tiles is what ``csrc/flash_attention.cu``
    compiles and its C entry accepts, and the tuner's shared memory and
    ring depth are the kernel's."""
    text = (CSRC / "flash_attention.cu").read_text()
    entry = text[text.index("// the compiled (Dh, BK) instances"):]
    entry = entry[:entry.index("\n}\n")]
    compiled = sorted((int(d), int(b)) for d, b in re.findall(
        r"Dh == (\d+) && bk == (\d+)\)\s+return launch_dh<\1, \2>", entry))
    assert compiled == sorted((dh, bk) for dh, bks in
                              fa.WGMMA_BLOCK_K.items() for bk in bks)
    assert sorted(fa.WGMMA_BLOCK_K) == list(fa.WGMMA_HEAD_DIMS)
    assert all(fa.DEFAULT_BLOCK_K[dh] in bks
               for dh, bks in fa.WGMMA_BLOCK_K.items())
    assert "STAGES = DH <= 128 ? 256 / BK : 3;" in text
    assert f"constexpr int BQ = {fa.WGMMA_BLOCK_Q};" in text
    assert f"SMEM_LIMIT = {autotune.SMEM_LIMIT};" in text
    # the 128-key instances the serving paths launch: 81 KB at Dh 64, 161
    # KB at Dh 128 and 256 (the kernel's comment)
    assert autotune.attention_smem(64, 128) == (1024 + 16384 + 2 * 32768
                                                + 8 * 5, 2)
    assert autotune.attention_smem(128, 64)[1] == 4
    assert autotune.attention_smem(256, 32)[1] == 3


def test_block_k_argument_is_checked():
    q = torch.randn(1, 70, 4, 128)
    k = v = torch.randn(1, 70, 2, 128)
    want = fa.flash_attention(q, k, v)
    for bk in fa.WGMMA_BLOCK_K[128]:
        assert torch.equal(fa.flash_attention(q, k, v, block_k=bk), want)
    for bk, dh in ((96, 128), (32, 128), (256, 256), (64, 80)):
        qq = torch.randn(1, 70, 4, dh)
        kk = torch.randn(1, 70, 2, dh)
        with pytest.raises(ValueError, match="key tiles"):
            fa.flash_attention(qq, kk, kk, block_k=bk)


def test_tuned_attention_runs_and_matches():
    """The twin of the JAX test, on numpy-seeded inputs: the port's pick
    through the plain version on the CPU, the JAX pick (capped at 128, as
    the JAX test caps it) through the Pallas kernel in interpret mode."""
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_pallas
    S, Dh = 256, 64
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, S, 4, Dh)).astype(np.float32)
    k = rng.standard_normal((1, S, 2, Dh)).astype(np.float32)
    v = rng.standard_normal((1, S, 2, Dh)).astype(np.float32)
    t = autotune.tune_flash_attention(S, Dh, causal=True)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, block_k=t.block_k)
    jt = jautotune.tune_flash_attention(S, Dh)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  block_q=min(jt.block_q, 128),
                                  block_k=min(jt.block_k, 128),
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-5)


def test_long_seq_choice_is_not_memory_bound():
    """The JAX property at S 32768, Dh 128, bf16 in the card's form.  The
    JAX model re-reads K/V for every query tile: 4.29 GB, 1.28 ms at 3.35
    TB/s, above the products' 0.556 ms at 989 TFLOP/s, so on the card its
    property would not hold.  The card's blocks resident at once share K/V
    through the 50 MB L2, which holds one head's 16.8 MB, so the port's
    model reads it once: the pick sits on the compute side of the roofline,
    and its time is that side plus the key tiles' fixed cost."""
    S, Dh = 32768, 128
    t = autotune.tune_flash_attention(S, Dh)
    compute_bound = 4.0 * S * S * Dh / autotune.PEAK_FLOPS
    jax_restream = (2 * S * Dh * 2 * (S // t.block_q)
                    + S * Dh * 2) / autotune.HBM_BW
    assert jax_restream > compute_bound            # the JAX model's miss
    assert 2 * S * Dh * 2 <= autotune.L2_BYTES
    assert t.memory_seconds == pytest.approx(
        (2 * S * Dh * 2 + 2 * S * Dh * 2) / autotune.HBM_BW)
    assert t.memory_seconds <= compute_bound <= t.compute_seconds
    # 256 equal blocks on 132 SMs: the last SM computes two of them
    assert t.compute_seconds == pytest.approx(
        2 * compute_bound * autotune.SMS / 256)
    assert t.est_seconds == pytest.approx(t.compute_seconds
                                          + t.tile_seconds)


def test_short_rows_pick_fewer_key_tiles():
    """At qwen3-8b's S 77, both of Dh 128's key tiles compute 128 padded
    keys; the 128-key tile steps once, the 64-key tile twice."""
    ranked = autotune.rank_flash_attention(77, 128, 32, causal=True,
                                           kv_heads=8)
    assert [t.block_k for t in ranked] == [128, 64]
    assert ranked[1].tile_seconds == 2 * ranked[0].tile_seconds
