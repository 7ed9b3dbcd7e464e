"""The port's flash attention and its twins against the JAX package:
``flash_attention`` (Pallas, interpret mode), ``attention_ref`` and
``attention_chunked``.

On the CPU ``repro_torch.kernels.flash_attention.flash_attention`` runs
its plain twin ``flash_attention_plain`` (the Pallas schedule written
out). Tolerances: f32 1e-5 (both sides sum the same f32 products, in
other orders); bf16 3e-2 abs/rel (the JAX test's own bound for bf16
output against the f32 oracle: one bf16 ulp at |x| < 4 is <= 1.6e-2).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.chunked import attention_chunked as j_chunked  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as TF  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import attention_chunked as t_chunked  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref as t_ref  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 3e-2


def _qkv(B, H, Hkv, S, D, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("S,D", [(128, 64), (256, 32), (256, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax(S, D, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 2, 2, S, D)
    got = TF.flash_attention(tq, tk, tv, causal=causal, block_q=128, block_k=128)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got, j_flash(jq, jk, jv, causal=causal, block_q=128, block_k=128), F32_TOL)
    _close(got, j_ref(jq, jk, jv, causal=causal), F32_TOL)


@pytest.mark.parametrize("H,Hkv", [(8, 2), (8, 8), (6, 1), (4, 2)])
def test_flash_gqa_head_mapping(H, Hkv):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, H, Hkv, 128, 64, seed=1)
    got = TF.flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    _close(got, j_flash(jq, jk, jv, causal=True, block_q=64, block_k=64), F32_TOL)
    _close(t_ref(tq, tk, tv, causal=True), j_ref(jq, jk, jv, causal=True), F32_TOL)


@pytest.mark.parametrize("window", [16, 48, 300])
def test_flash_sliding_window(window):
    """window=16 with 64-row blocks: kv blocks that are fully masked for
    some rows of a kept block exercise the finite -1e30 sentinel."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, 256, 32, seed=2)
    got = TF.flash_attention(tq, tk, tv, causal=True, window=window, block_q=64, block_k=64)
    assert torch.isfinite(got).all()
    _close(got, j_flash(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64),
           F32_TOL)
    _close(got, j_ref(jq, jk, jv, causal=True, window=window), F32_TOL)


def test_flash_noncausal_window():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 1, 128, 32, seed=6)
    got = TF.flash_attention(tq, tk, tv, causal=False, window=40, block_q=64, block_k=32)
    _close(got, j_ref(jq, jk, jv, causal=False, window=40), F32_TOL)


def test_flash_bf16():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, 128, 64, seed=3, dtype="bfloat16")
    got = TF.flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    _close(got, j_flash(jq, jk, jv, causal=True, block_q=64, block_k=64), BF16_TOL)
    _close(got, j_ref(jq, jk, jv, causal=True), BF16_TOL)


def test_flash_uneven_blocks():
    """block_q != block_k and blocks smaller than S."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, 256, 32, seed=4)
    got = TF.flash_attention(tq, tk, tv, causal=True, block_q=128, block_k=64)
    _close(got, j_flash(jq, jk, jv, causal=True, block_q=128, block_k=64), F32_TOL)


def test_flash_default_blocks_cap_at_seq():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 2, 96, 16, seed=7)
    _close(TF.flash_attention(tq, tk, tv), j_flash(jq, jk, jv), F32_TOL)


def test_custom_scale():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, 128, 32, seed=5)
    got = TF.flash_attention(tq, tk, tv, causal=False, scale=0.5, block_q=64, block_k=64)
    _close(got, j_flash(jq, jk, jv, causal=False, scale=0.5, block_q=64, block_k=64),
           F32_TOL)
    _close(got, j_ref(jq, jk, jv, causal=False, scale=0.5), F32_TOL)


@pytest.mark.parametrize("S,bq,bk", [(200, 128, 128), (192, 128, 64), (256, 96, 64)])
def test_flash_rejects_indivisible(S, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, S, 16)
    with pytest.raises(ValueError):
        j_flash(jq, jk, jv, block_q=bq, block_k=bk)
    with pytest.raises(ValueError, match="divisible"):
        TF.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)


def test_flash_rejects_bad_heads_and_devices():
    _, (tq, tk, tv) = _qkv(1, 6, 4, 64, 16)
    with pytest.raises(ValueError, match="kv heads"):
        TF.flash_attention(tq, tk, tv)
    meta = [t.to("meta") for t in _qkv(1, 2, 2, 64, 16)[1]]
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_attention(*meta)


@pytest.mark.parametrize(
    "causal,window,chunk", [(True, None, 64), (False, None, 48), (True, 40, 100), (True, 16, 256)]
)
def test_chunked_matches_jax(causal, window, chunk):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 4, 2, 160, 32, seed=8)
    got = t_chunked(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    _close(got, j_chunked(jq, jk, jv, causal=causal, window=window, chunk=chunk), F32_TOL)
    _close(got, t_ref(tq, tk, tv, causal=causal, window=window), F32_TOL)


def test_ref_bf16_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 2, 64, 32, seed=9, dtype="bfloat16")
    got = t_ref(tq, tk, tv, causal=True, window=20)
    assert got.dtype == torch.bfloat16
    _close(got, j_ref(jq, jk, jv, causal=True, window=20), BF16_TOL)


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_route_16bit_multiple_of_16_is_wgmma(dtype, D):
    assert TF._route(getattr(torch, dtype), D) == "wgmma"


@pytest.mark.parametrize("D", [8, 16, 24, 40, 64, 72, 120, 128])
def test_route_f32_is_tf32x3(D):
    """f32 up to TF32X3_MAX_D goes to the 3xTF32 tensor-core kernel."""
    assert TF._route(torch.float32, D) == "tf32x3"


@pytest.mark.parametrize("D", [136, 192, 200, 256])
def test_route_f32_beyond_128_is_tf32x3(D):
    """f32 head dims whose hi/lo tiles do not fit one block's shared
    memory run on the tf32x3 kernel as a pair of blocks, each holding
    half of D rounded up to 64."""
    assert D <= TF.TF32X3_MAX_D
    assert TF._route(torch.float32, D) == "tf32x3"
    half = _halves(D)[1].start
    assert half in (96, 128) and D <= 2 * half < D + 64


@pytest.mark.parametrize("D", [8, 24, 40, 200])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_route_16bit_multiple_of_8_is_wgmma(dtype, D):
    """16-bit head dims of 8 mod 16 take the tensor-core kernel too (its
    TMA rows of D * 2 bytes are a multiple of 16 bytes)."""
    assert TF._route(getattr(torch, dtype), D) == "wgmma"


@pytest.mark.parametrize("D", [0, 4, 12, 20, 264, 272, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_rejects_head_dims_no_kernel_takes(dtype, D):
    with pytest.raises(ValueError, match="head dim"):
        TF._route(getattr(torch, dtype), D)


def test_route_rejects_other_dtypes():
    with pytest.raises(TypeError):
        TF._route(torch.float64, 64)


def test_launch_counters_per_route():
    assert TF.ROUTES == ("wgmma", "tf32x3")
    assert TF.flash_attention.launches_by_route.keys() == dict.fromkeys(TF.ROUTES, 0).keys()


# ---- the tf32x3 route's arithmetic, emulated on the CPU ----------------------
#
# The kernel rounds with cvt.rna.tf32.f32 (10 mantissa bits, to nearest,
# ties away from zero), multiplies TF32 values exactly and sums in f32.
# The emulation below does the same with f32 tensors whose values are
# TF32, on the kernel's 32-row kv tiles and 64-row q tiles.

TF32X3_BN = 32  # kv rows per tile of the kernel


def _tf32_rna(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _kv_positions(n):
    """kv row held by each position of the kernel's V^T (n positions)."""
    order = torch.tensor(TF.TF32X3_KV_ORDER)
    pos = torch.arange(n)
    return pos // 8 * 8 + order[pos % 8]


def _halves(D):
    """The head-dim columns each block of the tf32x3 kernel holds: all of
    them for a lone block (D <= 128); above, block r of the pair holds
    [r DPH, (r + 1) DPH) with DPH half of D rounded up to 64 (96 or 128)."""
    if D <= 128:
        return [slice(0, D)]
    half = -(-D // 64) * 32
    return [slice(0, half), slice(half, D)]


def _flash_tf32_emulated(q, k, v, *, causal=True, window=None, terms=3):
    """The tf32x3 kernel's schedule: S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi,
    online softmax over 32-row kv tiles, P split in hi/lo and multiplied
    with V^T stored in TF32X3_KV_ORDER. Above D = 128 each block of the
    pair computes the partial scores of its half of the head dim, the
    two partials are summed, and each block's P V fills its half of the
    output. ``terms=1`` keeps only the hi products: a single TF32
    product, as a kernel that dropped lo would."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    Sp = -(-S // TF32X3_BN) * TF32X3_BN
    kp = torch.zeros(B, Hkv, Sp, D)
    vp = torch.zeros(B, Hkv, Sp, D)
    kp[:, :, :S], vp[:, :, :S] = k, v
    kv_of = _kv_positions(Sp)
    qh, ql = _split(q.reshape(B, Hkv, g, S, D))
    kh, kl = _split(kp)
    vth, vtl = _split(vp[:, :, kv_of].transpose(-1, -2))  # (B, Hkv, D, Sp)
    out = torch.empty(B, Hkv, g, S, D)
    for q0 in range(0, S, 64):
        rows = torch.arange(q0, min(q0 + 64, S))[:, None]
        m = torch.full((B, Hkv, g, len(rows), 1), TF.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, g, len(rows), D)
        for k0 in range(0, Sp, TF32X3_BN):
            tile = slice(k0, k0 + TF32X3_BN)

            def qk(a, b, cols):
                return torch.einsum("bhgqd,bhkd->bhgqk", a[:, :, :, q0:q0 + 64, cols],
                                    b[:, :, tile, cols])

            def pv(a, b, cols):
                return torch.einsum("bhgqk,bhdk->bhgqd", a, b[:, :, cols, tile])

            partials = [qk(qh, kh, c) if terms == 1 else
                        qk(ql, kh, c) + qk(qh, kl, c) + qk(qh, kh, c) for c in _halves(D)]
            s = partials[0] if len(partials) == 1 else partials[0] + partials[1]
            s = s * D ** -0.5
            cols = torch.arange(k0, k0 + TF32X3_BN)[None, :]
            keep = (cols < S) & (rows >= 0)
            if causal:
                keep = keep & (cols <= rows)
            if window is not None:
                keep = keep & (cols > rows - window)
            s = torch.where(keep, s, torch.full_like(s, TF.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
            ph, pl = _split(p[..., kv_of[tile] - k0])  # the fragment's column order
            o = torch.cat([pv(ph, vth, c) if terms == 1 else
                           pv(pl, vth, c) + pv(ph, vtl, c) + pv(ph, vth, c)
                           for c in _halves(D)], dim=-1)
            acc = acc * alpha + o
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, :, q0:q0 + 64] = acc / l
    return out.reshape(B, H, S, D)


def _low_mantissa_v(rng, shape):
    """V just below TF32's rounding midpoint above 1 (1 + 2^-11 - k 2^-22,
    k in 1..128): every hi part is 1 and the lo part carries ~2^-11, so
    a kernel that drops the lo products is off by ~4.7e-4 everywhere."""
    return (1 + (2048 - rng.integers(1, 129, shape)) * 2.0 ** -22).astype(np.float32)


def test_tf32_rounding_emulates_cvt_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1 + 3 * 2 ** -11,
                      1 + 2 ** -10, 3.0e-39])
    want = torch.tensor([1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 * 2 ** -10,
                         1 + 2 ** -10, 3.0e-39])
    got = _tf32_rna(x)
    assert torch.equal(got, _tf32_rna(got))  # TF32 values stay put
    assert torch.equal(got[:6], want[:6])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.default_rng(11)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = _split(y)
    assert torch.all((hi + lo - y).abs() <= y.abs() * 2.0 ** -21)
    assert torch.all((hi - y).abs() <= y.abs() * 2.0 ** -11)


def test_tf32x3_kv_order_matches_the_fragment_layouts():
    """The accumulator gives thread (g, c) of a warp score columns 2c and
    2c + 1 of each 8-column slice (registers 4i + e: row g + 8 (e // 2),
    column 8i + 2c + e % 2); the TF32 A fragment wants (g, c), (g + 8, c),
    (g, c + 4), (g + 8, c + 4) in its four registers. The kernel passes
    registers (4i, 4i + 2, 4i + 1, 4i + 3), so fragment column j is kv
    TF32X3_KV_ORDER[j] of the slice; the sum over kv is then P V."""
    acc = {}  # (lane, register e) -> (row, column) within one 16 x 8 slice
    frag = {}  # (lane, register r) -> (row, fragment column)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for e in range(4):
            acc[lane, e] = (g + 8 * (e // 2), 2 * c + e % 2)
        for r, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            frag[lane, r] = (g + dr, c + dc)
    passed = (0, 2, 1, 3)  # fragment register r <- accumulator register passed[r]
    order = {}
    for lane in range(32):
        for r in range(4):
            row, col = acc[lane, passed[r]]
            frow, j = frag[lane, r]
            assert row == frow
            assert order.setdefault(j, col) == col
    assert tuple(order[j] for j in range(8)) == TF.TF32X3_KV_ORDER
    rng = np.random.default_rng(12)
    p = torch.from_numpy(rng.standard_normal((16, 64)))
    v = torch.from_numpy(rng.standard_normal((64, 24)))
    kv_of = _kv_positions(64)
    assert torch.allclose(p[:, kv_of] @ v[kv_of], p @ v)


@pytest.mark.parametrize(
    "B,H,Hkv,S,D,causal,window,values",
    [
        (1, 4, 2, 200, 64, True, None, "normal"),
        (2, 4, 1, 96, 40, False, None, "normal"),
        (1, 4, 2, 160, 128, True, 48, "normal"),
        (1, 2, 2, 128, 32, True, None, "scaled"),
        (1, 4, 2, 200, 64, True, 48, "low_mantissa"),
        (1, 4, 1, 200, 40, False, None, "low_mantissa"),
        # above D = 128: a pair of blocks, each with half the head dim
        (1, 4, 2, 200, 136, True, None, "normal"),
        (2, 4, 1, 96, 192, False, None, "scaled"),
        (1, 4, 2, 160, 200, True, 48, "normal"),
        (1, 4, 2, 200, 256, True, None, "low_mantissa"),
    ],
)
def test_tf32x3_emulation_within_f32_tolerance(B, H, Hkv, S, D, causal, window, values):
    """At (1e-4, 1e-4) against the JAX f32 flash kernel the 3xTF32
    schedule passes and a single TF32 product fails: the card test's
    tolerance catches a kernel that drops the lo terms."""
    rng = np.random.default_rng(13)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    if values == "scaled":  # peaked softmax: larger scores, larger TF32 error
        arrs[0] *= 3
        arrs[1] *= 3
    if values == "low_mantissa":
        arrs[2] = _low_mantissa_v(rng, arrs[2].shape)
    want = np.asarray(j_flash(*[jnp.asarray(a) for a in arrs], causal=causal, window=window,
                              block_q=S, block_k=S), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    got = _flash_tf32_emulated(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    one = _flash_tf32_emulated(tq, tk, tv, causal=causal, window=window, terms=1).numpy()
    assert (np.abs(one - want) > 1e-4 + 1e-4 * np.abs(want)).any()


@pytest.mark.parametrize("D", [136, 192, 256])
def test_tf32x3_pair_scores_are_bit_identical(D):
    """Each block of a pair adds its peer's partial scores to its own, so
    block 0 computes s0 + s1 and block 1 s1 + s0: f32 addition commutes,
    so both hold the same scores bit for bit and run the same softmax,
    on partials that differ and round (peaked scores, TF32 splits)."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32)) * 3
    k = torch.from_numpy(rng.standard_normal((32, D)).astype(np.float32)) * 3
    qh, ql = _split(q)
    kh, kl = _split(k)
    s0, s1 = (ql[:, c] @ kh[:, c].T + qh[:, c] @ kl[:, c].T + qh[:, c] @ kh[:, c].T
              for c in _halves(D))
    assert s0.dtype == torch.float32 and not torch.equal(s0, s1)
    assert torch.equal((s0 + s1).view(torch.int32), (s1 + s0).view(torch.int32))


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_query_offset_is_a_block_of_the_full_result(impl, causal, window):
    """``q_offset`` (the sequence-sharded attention's query block): the
    plain attentions and the flash wrapper (its plain twin here) on
    query rows ``[start, stop)`` of a sequence, with K/V of all of it,
    equal rows ``[start, stop)`` of the full result within 1e-6 (f32),
    for uneven and empty blocks; the chunked form with a chunk (5) that
    does not divide the 12 keys."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((2, 4, 12, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 12, 8)).astype(np.float32))
            for _ in range(2))

    def attend(qb, offset):
        if impl == "flash":
            return TF.flash_attention(qb, k, v, causal=causal, window=window, q_offset=offset)
        if impl == "chunked":
            return t_chunked(qb, k, v, causal=causal, window=window, chunk=5, q_offset=offset)
        return t_ref(qb, k, v, causal=causal, window=window, q_offset=offset)

    full = attend(q, 0)
    for start, stop in ((0, 4), (4, 9), (9, 12), (12, 12)):
        part = attend(q[:, :, start:stop], start)
        np.testing.assert_allclose(part.numpy(), full[:, :, start:stop].numpy(), atol=1e-6,
                                   rtol=0)


# (Sk, Sq, offsets, causal, window, blocks): a sequence-sharded rank's
# query block against the whole sequence's keys — whisper's decoder
# (causal) and encoder (non-causal, blocks that divide 60 frames but not
# the rank's 15), a window that cuts inside a block, GQA; the offsets
# include blocks that do not start on a 64-row tile or a block boundary
OFFSET_CASES = [
    (64, 16, (0, 16, 48), True, None, (512, 512)),
    (60, 15, (0, 45), False, None, (20, 20)),
    (96, 24, (0, 40, 72), True, 20, (32, 32)),
    (96, 24, (8, 72), False, 30, (48, 48)),
]


@pytest.mark.parametrize("Sk,Sq,offsets,causal,window,blocks", OFFSET_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_query_offset_matches_jax_rows(Sk, Sq, offsets, causal, window, blocks,
                                                   dtype):
    """The plain twin with ``Sq != Sk`` and ``q_offset`` against the
    matching rows of the JAX package's ``attention_ref`` on the whole
    sequence (6 query heads on 2 KV heads, D = 16, seeded numpy inputs):
    f32 within 1e-5, bf16 within 3e-2 (the module's tolerances)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 6, 2, Sk, 16, seed=5, dtype=dtype)
    whole = np.asarray(j_ref(jq, jk, jv, causal=causal, window=window).astype(jnp.float32))
    for off in offsets:
        got = TF.flash_attention_plain(tq[:, :, off:off + Sq].contiguous(), tk, tv,
                                       causal=causal, window=window, block_q=blocks[0],
                                       block_k=blocks[1], q_offset=off)
        assert got.shape == (2, 6, Sq, 16) and got.dtype == tq.dtype
        _close(got, whole[:, :, off:off + Sq], BF16_TOL if dtype == "bfloat16" else F32_TOL)


def test_flash_query_offset_keeps_the_whole_sequences_contract():
    """The offset call's blocks divide the whole sequence (the JAX
    entry's call on it), not the rank's rows; rows past the keys
    raise."""
    _, (q, k, v) = _qkv(1, 2, 2, 60, 16)
    TF.flash_attention(q[:, :, 45:], k, v, block_q=20, block_k=20, q_offset=45)
    with pytest.raises(ValueError, match="divisible"):
        TF.flash_attention(q[:, :, 45:], k, v, block_q=16, block_k=20, q_offset=45)
    with pytest.raises(ValueError, match="rows"):
        TF.flash_attention(q[:, :, 45:], k, v, block_q=20, block_k=20, q_offset=50)
