"""The port's flash_attention wrapper against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain version, so these tests
hold its masks, positions, GQA, softcap and strides to the reference:
the Pallas kernel in interpret mode and its oracle
``flash_attention_ref``, as tests/test_kernels.py runs them, and the
reference model's ``_attend`` for the position tensors the decode path
passes.  The kernel itself is held to the plain version on the card (the
``cuda`` test below, and chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    combine_ref, decode_partials_ref, flash_attention, flash_attention_ref,
    ops, tensor_core_emulation)
from test_torch_support import chip_smoke, reference


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def allclose(a, b, tol):
    """tests/test_kernels.py's rule: atol tol * max(1, |ref|max)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


def kernel_close(out, ref):
    """The kernel's output against the plain version's float32 result on
    the same inputs, element by element (chip_smoke.py's rule): float32
    in another order within 1e-5 absolute and relative, and a bfloat16
    output rounded once, by at most half an ulp (2^-8 of |ref|) more."""
    rtol = 1e-5 + (2.0 ** -8 if out.dtype == torch.bfloat16 else 0.0)
    err = (out.float() - ref).abs()
    assert bool((err <= 1e-5 + rtol * ref.abs()).all()), float(err.max())


def close_rel(a, b, rtol=1e-5):
    """Max |a - b| within rtol of max |b| (float32 in another order)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    err = float(np.abs(a - b).max())
    assert err <= rtol * float(np.abs(b).max()), err


def _qkv(seed, B, H, KV, Sq, Skv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd), np.float32),
            rng.standard_normal((B, KV, Skv, hd), np.float32),
            rng.standard_normal((B, KV, Skv, hd), np.float32))


def _torch(a, dtype=torch.float32):
    return torch.tensor(a).to(dtype)


# tests/test_kernels.py:113-131
KERNEL_CASES = [
    (2, 4, 2, 256, 64, True, None, 0.0),
    (1, 4, 4, 256, 64, True, 128, 0.0),
    (1, 8, 2, 128, 64, True, None, 50.0),
    (2, 2, 2, 256, 64, False, None, 0.0),
    (1, 2, 1, 512, 128, True, 256, 30.0),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,cap", KERNEL_CASES)
def test_plain_version_matches_pallas_and_oracle(ref, B, H, KV, S, hd,
                                                  causal, window, cap, bf16):
    jnp = ref.jnp
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    q, k, v = _qkv(0, B, H, KV, S, S, hd)
    # both packages see the same (rounded) inputs
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    qt, kt, vt = (_torch(np.asarray(a.astype(jnp.float32)), tdt)
                  for a in (qj, kj, vj))
    ours = flash_attention(qt, kt, vt, causal=causal, window=window,
                           softcap=cap)
    assert ours.dtype == tdt and ours.shape == qt.shape
    pallas = ref.flash.flash_attention(qj, kj, vj, causal=causal,
                                       window=window, softcap=cap, bq=64,
                                       bk=64)
    oracle = ref.flash.flash_attention_ref(qj, kj, vj, causal=causal,
                                           window=window, softcap=cap)
    tol = 2e-2 if bf16 else 2e-5
    ours = ours.float().numpy()
    allclose(ours, np.asarray(pallas.astype(jnp.float32)), tol)
    allclose(ours, np.asarray(oracle.astype(jnp.float32)), tol)


# the audio family's cross attention: Sq decoder queries over Skv encoder
# frames, non-causal, MHA (group 1) at hd 64
CROSS_CASES = [(2, 4, 4, 16, 32, 64), (1, 4, 4, 128, 256, 64)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd", CROSS_CASES)
def test_cross_shapes_match_pallas_and_oracle(ref, B, H, KV, Sq, Skv, hd,
                                              bf16):
    """Sq != Skv with causal=False and no positions (every key valid):
    the plain version against the Pallas kernel in interpret mode and its
    oracle, as test_plain_version_matches_pallas_and_oracle does."""
    jnp = ref.jnp
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    q, k, v = _qkv(15, B, H, KV, Sq, Skv, hd)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    qt, kt, vt = (_torch(np.asarray(a.astype(jnp.float32)), tdt)
                  for a in (qj, kj, vj))
    ours = flash_attention(qt, kt, vt, causal=False)
    assert ours.dtype == tdt and ours.shape == qt.shape
    pallas = ref.flash.flash_attention(qj, kj, vj, causal=False, bq=64,
                                       bk=64)
    oracle = ref.flash.flash_attention_ref(qj, kj, vj, causal=False)
    tol = 2e-2 if bf16 else 2e-5
    ours = ours.float().numpy()
    allclose(ours, np.asarray(pallas.astype(jnp.float32)), tol)
    allclose(ours, np.asarray(oracle.astype(jnp.float32)), tol)


def _ring(B, size, pos, rng):
    """Per-row ring-buffer slot positions after decoding up to ``pos[b]``
    (inclusive): slot s holds the newest position p <= pos[b] with
    p % size == s, or -1 if none."""
    kpos = np.full((B, size), -1, np.int32)
    for b in range(B):
        for p in range(int(pos[b]) + 1):
            kpos[b, p % size] = p
    return kpos


# B, Q, H, KV, S, window, cap, per-row positions
POSITION_CASES = [
    (3, 1, 4, 2, 16, None, 0.0, True),      # decode, partly written cache
    (3, 1, 4, 2, 8, 8, 0.0, True),          # decode, wrapped ring window
    (2, 1, 8, 2, 32, None, 50.0, True),     # decode, softcap
    (1, 24, 4, 2, 24, 16, 0.0, False),      # prefill, 1-D positions
    (2, 5, 4, 4, 12, 4, 30.0, True),        # per-row query positions
]


@pytest.mark.parametrize("B,Q,H,KV,S,window,cap,per_row", POSITION_CASES)
def test_positions_match_reference_attend(ref, B, Q, H, KV, S, window, cap,
                                          per_row):
    rng = np.random.default_rng(1)
    hd = 64
    q = rng.standard_normal((B, Q, H, hd), np.float32)
    k = rng.standard_normal((B, S, KV, hd), np.float32)
    v = rng.standard_normal((B, S, KV, hd), np.float32)
    if per_row:
        last = rng.integers(Q + 2, 3 * S, B)
        qpos = (last[:, None] - np.arange(Q)[::-1]).astype(np.int32)
        kpos = _ring(B, S, last, rng)
    else:
        qpos = kpos = np.arange(S, dtype=np.int32)
    jnp = ref.jnp
    theirs = ref.attention._attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), causal=True, window=window, cap=cap,
        scale=hd ** -0.5)
    ours = flash_attention(
        torch.tensor(q).transpose(1, 2), torch.tensor(k).transpose(1, 2),
        torch.tensor(v).transpose(1, 2), causal=True, window=window,
        softcap=cap, q_pos=torch.tensor(qpos), k_pos=torch.tensor(kpos))
    close_rel(ours.transpose(1, 2).numpy(), np.asarray(theirs))


def test_row_with_no_valid_key_is_zero(ref):
    """The one documented difference (ref.py): the kernel's plain version
    gives 0 on a row that sees no key, the reference model's ``_attend``
    the mean of v.  No row on the serving path is fully masked."""
    q, k, v = _qkv(2, 1, 2, 1, 2, 4, 64)
    qpos = np.array([[-5, 3]], np.int32)          # row 0 sees nothing
    kpos = np.array([[0, 1, 2, 3]], np.int32)
    ours = flash_attention(_torch(q), _torch(k), _torch(v),
                           q_pos=torch.tensor(qpos),
                           k_pos=torch.tensor(kpos)).numpy()
    assert not ours[:, :, 0].any()
    jnp = ref.jnp
    theirs = np.asarray(ref.attention._attend(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(qpos),
        jnp.asarray(kpos), causal=True, window=None, cap=0.0,
        scale=64 ** -0.5))
    np.testing.assert_allclose(theirs[0, 0, 0], v[0, 0].mean(0), rtol=1e-5,
                               atol=1e-6)
    close_rel(ours[:, :, 1], theirs[:, 1])


def test_default_positions_are_the_iota_mask():
    q, k, v = (_torch(a) for a in _qkv(3, 2, 4, 2, 9, 9, 64))
    iota = torch.arange(9, dtype=torch.int32)
    for kw in ({}, {"window": 3}, {"causal": False}):
        a = flash_attention(q, k, v, **kw)
        b = flash_attention(q, k, v, q_pos=iota, k_pos=iota[None].expand(
            2, 9).contiguous(), **kw)
        assert torch.equal(a, b), kw


def test_strided_views_equal_contiguous_inputs():
    q, k, v = (_torch(a) for a in _qkv(4, 2, 4, 2, 7, 7, 64))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(flash_attention(*views, window=4),
                       flash_attention(q, k, v, window=4))


def test_refuses_what_the_kernel_does_not_take():
    q, k, v = (_torch(a) for a in _qkv(5, 1, 4, 2, 4, 4, 64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="int32"):
        flash_attention(q, k, v, q_pos=torch.arange(4))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


def test_cpu_path_counts_no_launches():
    before = flash_attention.launches
    flash_attention(*(_torch(a) for a in _qkv(6, 1, 2, 1, 3, 3, 64)))
    assert flash_attention.launches == before


def _bf16_qkv(seed, B, H, KV, S, hd):
    return tuple(_torch(a, torch.bfloat16)
                 for a in _qkv(seed, B, H, KV, S, S, hd))


@pytest.mark.parametrize("split_p,passes", [(True, True), (False, False)],
                         ids=["p_split_hi_lo", "p_rounded_once"])
def test_tensor_core_numerics_meet_the_chip_check(split_p, passes):
    """The wgmma route's arithmetic, emulated (ref.tensor_core_emulation)
    at a reduced serving shape (causal, GQA group 7, hd 128, S = 512,
    bf16 inputs): with P split into bf16 hi and lo parts it meets
    chip_smoke.py's element-by-element limit against the float32 plain
    version (the bf16 output rounding takes up most of it); rounding P
    to bf16 once, as SDPA does, puts a fifth of the outputs over it."""
    q, k, v = _bf16_qkv(11, 1, 7, 1, 512, 128)
    plain = flash_attention_ref(q.float(), k.float(), v.float())
    out = tensor_core_emulation(q, k, v, split_p=split_p)
    assert out.dtype == torch.bfloat16
    excess = chip_smoke().attn_excess(out, plain)
    if passes:
        assert excess <= 1.0, excess
    else:
        assert excess > 10.0, excess


def test_tensor_core_emulation_masks_like_the_plain_version():
    """Windows, softcaps, ring positions and tails: the emulation sees
    the same keys as the plain version (within bf16 of it)."""
    rng = np.random.default_rng(12)
    q, k, v = _bf16_qkv(12, 2, 4, 2, 100, 64)
    for kw in ({"window": 30}, {"softcap": 30.0}, {"causal": False}):
        out = tensor_core_emulation(q, k, v, **kw)
        plain = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        assert chip_smoke().attn_excess(out, plain) <= 1.0, kw
    last = rng.integers(150, 400, 2)
    kpos = torch.tensor(_ring(2, 100, last, rng))
    qpos = torch.tensor(last[:, None].astype(np.int32))
    q1 = q[:, :, :1]
    out = tensor_core_emulation(q1, k, v, q_pos=qpos, k_pos=kpos)
    plain = flash_attention_ref(q1.float(), k.float(), v.float(),
                                q_pos=qpos, k_pos=kpos)
    assert chip_smoke().attn_excess(out, plain) <= 1.0


@pytest.mark.parametrize("Sq,Skv", [(16, 1024), (100, 1024), (1024, 1024),
                                    (1, 1024)])
def test_tensor_core_emulation_non_causal(Sq, Skv):
    """The wgmma route's numerics at the audio family's non-causal shapes
    (cross attention of Sq queries over 1,024 frames, the encoder's
    1,024 over 1,024, MHA at hd 64, no positions: every key valid) meet
    chip_smoke.py's element-by-element limit against the plain
    version."""
    q, k, v = (_torch(a, torch.bfloat16)
               for a in _qkv(16, 1, 2, 2, Sq, Skv, 64))
    plain = flash_attention_ref(q.float(), k.float(), v.float(),
                                causal=False)
    out = tensor_core_emulation(q, k, v, causal=False)
    assert chip_smoke().attn_excess(out, plain) <= 1.0


@pytest.mark.parametrize("window", [None, 256], ids=["global", "local"])
def test_tensor_core_emulation_at_gemma2_shapes(window):
    """The wgmma route's numerics at head dim 256, gemma2-2b's (8 heads
    over 4, softcap 50; S = 700, so 1,400 rows end in a 56-row tile),
    global and windowed: within chip_smoke.py's element-by-element limit
    against the float32 plain version.  The two-warpgroup block splits
    O's columns, not the arithmetic of a column, so this is the check the
    card holds the hd-256 kernel to."""
    q, k, v = _bf16_qkv(29, 1, 8, 4, 700, 256)
    kw = {"softcap": 50.0, "window": window}
    plain = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    out = tensor_core_emulation(q, k, v, **kw)
    assert chip_smoke().attn_excess(out, plain) <= 1.0


@pytest.mark.parametrize("kw", [{"softcap": 50.0},
                                {"softcap": 50.0, "window": 300}],
                         ids=["global", "local"])
def test_split_k_at_head_dim_256_over_a_wrapped_ring(kw):
    """The split-K routes' arithmetic at gemma2-2b's head dim 256: a
    decode step of 4 rows (B = 4, group 2) over a 600-slot ring that has
    wrapped, its partials in ops.num_splits(600) = 3 splits merged by
    combine_ref, equals the plain version (float32 in another order)."""
    q, k, v, pos = _decode_inputs(31, 4, 8, 4, 600, 256, 700, 1500)
    assert bool((pos["k_pos"] >= 0).all()), "expected a wrapped ring"
    n = ops.num_splits(k.shape[2])
    m, l, o = decode_partials_ref(q, k, v, n_splits=n, **pos, **kw)
    kernel_close(combine_ref(m, l, o),
                 flash_attention_ref(q, k, v, **pos, **kw))


_WGMMA_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
             "kernels" / "flash_attention" / "csrc" /
             "flash_attention_wgmma.cu")


def _kernel_tanh(y):
    """flash_attention_wgmma.cu's ``tanh_f32`` step by step in float32
    (each fmaf exact in float64, then rounded once), its polynomial's
    coefficients read from the source; ex2 and rcp exact here (on the
    card each adds at most ~2^-22 relative)."""
    body = _WGMMA_CU.read_text().split("float tanh_f32(float y) {")[1]
    coef = [np.float32(c) for c in re.findall(
        r"([-+]?\d\.\d+e[-+]\d+)f", body.split("\n}\n")[0])]
    assert len(coef) == 9, coef
    f32, f64 = np.float32, np.float64
    u = (y * y).astype(f32)
    q = np.full_like(y, coef[0])
    for c in coef[1:]:
        q = (q.astype(f64) * u + c).astype(f32)
    small = ((y * u).astype(f32).astype(f64) * q + y).astype(f32)
    a = np.abs(y)
    with np.errstate(over="ignore"):       # e^2|y| -> inf: r = 0
        e = np.exp2((a * f32(2 * np.log2(np.e))).astype(f32).astype(f64))
        r = (1.0 / (e.astype(f32) + f32(1)).astype(f64)).astype(f32)
    big = np.copysign((1.0 - 2.0 * r.astype(f64)).astype(f32), y)
    return np.where(a < 1, small, big)


@pytest.mark.parametrize("lo,hi,ulps", [(0.0, 1.0, 1.0), (1.0, 12.0, 1.5),
                                        (12.0, 100.0, 0.5)],
                         ids=["polynomial", "exponential", "saturated"])
def test_kernel_tanh_is_float32_accurate(lo, hi, ulps):
    """The tensor-core kernel's softcap takes tanh from ``tanh_f32``,
    not tanhf: its odd polynomial below |y| = 1 and 1 - 2 / (e^2|y| + 1)
    above, emulated in float32, stay within ``ulps`` float32 ulps of
    tanh on both signs (tanhf's own is 2), and tanh(0) is 0."""
    y = np.linspace(lo, hi, 200_001).astype(np.float32)[1:]
    y = np.concatenate([y, -y])
    want = np.tanh(y.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(_kernel_tanh(y) - want) / ulp
    assert float(err.max()) <= ulps, float(err.max())
    assert _kernel_tanh(np.zeros(1, np.float32))[0] == 0.0


def _decode_inputs(seed, B, H, KV, size, hd, lo, hi):
    """A decode step over a ring of ``size`` slots after positions drawn
    in [lo, hi): partly written (slots at -1) or wrapped."""
    rng = np.random.default_rng(seed)
    q, k, v = (_torch(a) for a in _qkv(seed, B, H, KV, 1, size, hd))
    last = rng.integers(lo, hi, B)
    kpos = torch.tensor(_ring(B, size, last, rng))
    qpos = torch.tensor(last[:, None].astype(np.int32))
    return q, k, v, {"q_pos": qpos, "k_pos": kpos}


@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("lo,hi", [(20, 200), (700, 1500)],
                         ids=["partly_written", "wrapped"])
def test_split_k_combine_equals_plain_version(n_splits, lo, hi):
    """The split-K routes' arithmetic: per-split partials merged by
    combine_ref equal the plain version on decode ring positions (float32
    in another order: 1e-5), for any split count, splits with no visible
    key (a partly written ring leaves the last ones at -1) included."""
    q, k, v, pos = _decode_inputs(13, 4, 14, 2, 600, 64, lo, hi)
    for kw in ({}, {"window": 150}, {"softcap": 30.0}):
        m, l, o = decode_partials_ref(q, k, v, n_splits=n_splits, **pos,
                                      **kw)
        if lo < 200 and n_splits == 8:
            assert bool((l == 0).any()), "expected a split that sees nothing"
        kernel_close(combine_ref(m, l, o),
                     flash_attention_ref(q, k, v, **pos, **kw))


@pytest.mark.parametrize("Sq,causal", [(1, False), (16, False), (16, True),
                                       (64, False)])
def test_split_k_without_positions_equals_plain_version(Sq, causal):
    """The split-K routes at the audio family's calls of at most 64
    rows, with no position tensors: the cross attention (non-causal,
    Sq = 1 at decode, up to 64 at prefill, over 1,024 frames in 4
    splits) and the decoder's causal self-attention prefill (Sq = Skv,
    the later splits seeing nothing)."""
    Skv = Sq if causal else 1024
    q, k, v = (_torch(a) for a in _qkv(17, 2, 4, 4, Sq, Skv, 64))
    n = ops.num_splits(Skv)
    assert n == (1 if causal else 4)
    for n_splits in {n, 4}:
        m, l, o = decode_partials_ref(q, k, v, causal=causal,
                                      n_splits=n_splits)
        kernel_close(combine_ref(m, l, o),
                     flash_attention_ref(q, k, v, causal=causal))


def test_split_k_does_not_depend_on_the_batch():
    """The split count is a function of Skv alone, so a row's partials
    and its combined output are the same whatever batch it comes in."""
    q, k, v, pos = _decode_inputs(14, 4, 14, 2, 600, 64, 100, 1500)
    n = ops.num_splits(k.shape[2])
    whole = combine_ref(*decode_partials_ref(q, k, v, n_splits=n, **pos))
    for b in range(4):
        one = {key: t[b:b + 1] for key, t in pos.items()}
        alone = combine_ref(*decode_partials_ref(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], n_splits=n, **one))
        np.testing.assert_allclose(alone.numpy(), whole[b:b + 1].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_combine_of_nothing_is_zero():
    m = torch.full((2, 3), -torch.inf)
    l = torch.zeros((2, 3))
    o = torch.full((2, 3, 4), float("nan"))      # never read where l == 0
    assert torch.equal(combine_ref(m, l, o), torch.zeros((2, 4)))


@pytest.mark.parametrize("Sq,group,hd,dtype,want", [
    (1, 7, 128, torch.bfloat16, "split_k_wgmma"),    # qwen2-7b decode
    (1, 1, 128, torch.bfloat16, "split_k_wgmma"),    # deepseek decode
    (1, 4, 128, torch.bfloat16, "split_k_wgmma"),    # jamba decode
    (9, 7, 64, torch.bfloat16, "split_k_wgmma"),     # 63 rows
    (1, 7, 128, torch.float32, "split_k"),
    (1, 2, 256, torch.bfloat16, "split_k_wgmma"),    # gemma2 decode
    (1, 2, 256, torch.float32, "split_k"),
    (64, 1, 128, torch.bfloat16, "split_k_wgmma"),   # 64 rows
    (65, 1, 128, torch.bfloat16, "wgmma"),
    (10, 7, 64, torch.bfloat16, "wgmma"),            # 70 rows
    (1024, 7, 128, torch.bfloat16, "wgmma"),         # qwen2-7b prefill
    # seamless (group 1, hd 64): a prompt of up to 64 tokens, self or
    # cross attention, prefills on split-K; the encoder on wgmma
    (2, 1, 64, torch.bfloat16, "split_k_wgmma"),
    (16, 1, 64, torch.bfloat16, "split_k_wgmma"),
    (64, 1, 64, torch.bfloat16, "split_k_wgmma"),
    (100, 1, 64, torch.bfloat16, "wgmma"),
    (1024, 1, 64, torch.bfloat16, "wgmma"),          # seamless encoder
    (3392, 7, 128, torch.bfloat16, "wgmma"),         # llava prefill
    (1024, 7, 128, torch.float32, "cuda_cores"),
    (700, 2, 256, torch.bfloat16, "wgmma"),          # gemma2 prefill
    (700, 2, 256, torch.float32, "cuda_cores"),
])
def test_route_by_shape_and_dtype(Sq, group, hd, dtype, want):
    assert ops.route(Sq, group, hd, dtype) == want


@pytest.mark.parametrize("Skv,want", [(0, 1), (1, 1), (256, 1), (257, 2),
                                      (600, 3), (2048, 8), (2049, 9)])
def test_split_count_depends_on_slots_alone(Skv, want):
    assert ops.num_splits(Skv) == want == max(1, -(-Skv // ops.SPLIT_SLOTS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    """Runs only where there is a card (python3 chip_smoke.py covers the
    same ground at the serving path's shapes): every route, bf16 at hd
    64, 128 and 256, prefill tails and split-K decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(7)
    for B, H, KV, Sq, Skv, hd, causal, window, cap in [
            *[(B, H, KV, S, S, hd, c, w, cp)
              for B, H, KV, S, hd, c, w, cp in KERNEL_CASES],
            (1, 8, 4, 100, 77, 256, False, None, 0.0),
            (1, 16, 16, 16, 1024, 64, False, None, 0.0),
            (1, 16, 16, 100, 1024, 64, False, None, 0.0),
            (1, 8, 4, 300, 300, 256, True, 100, 30.0),
            (1, 28, 4, 300, 300, 64, True, None, 0.0),
            (1, 28, 4, 300, 300, 128, True, None, 0.0),
            (2, 28, 4, 1, 40, 128, True, 16, 0.0)]:
        q, k, v = (torch.tensor(a).to(dtype).cuda()
                   for a in _qkv(8, B, H, KV, Sq, Skv, hd))
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        plain = flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window, softcap=cap)
        kernel_close(out, plain)
    # decode over a ring cache, through transposed views: one split and
    # several (partly written and wrapped rings), GQA group 7 and 1
    for B, S, H, KV, hd, lo, hi in [(4, 64, 28, 4, 128, 1, 3 * 64),
                                    (3, 700, 28, 4, 128, 20, 500),
                                    (3, 700, 28, 4, 128, 800, 2000),
                                    (3, 700, 16, 16, 128, 800, 2000),
                                    (2, 600, 8, 2, 256, 100, 1200),
                                    (2, 600, 8, 2, 64, 100, 1200)]:
        last = rng.integers(lo, hi, B)
        kpos = torch.tensor(_ring(B, S, last, rng)).cuda()
        qpos = torch.tensor(last[:, None].astype(np.int32)).cuda()
        q = torch.randn(B, 1, H, hd, device="cuda", dtype=dtype)
        k = torch.randn(B, S, KV, hd, device="cuda", dtype=dtype)
        v = torch.randn(B, S, KV, hd, device="cuda", dtype=dtype)
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        assert ops.route(1, H // KV, hd, dtype).startswith("split_k")
        out = flash_attention(*args, q_pos=qpos, k_pos=kpos)
        plain = flash_attention_ref(*(t.float() for t in args), q_pos=qpos,
                                    k_pos=kpos)
        kernel_close(out, plain)
        assert torch.equal(out, flash_attention(*args, q_pos=qpos,
                                                k_pos=kpos))
