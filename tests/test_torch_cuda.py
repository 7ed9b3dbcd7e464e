"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances for flash attention: bf16/f16 outputs may differ from the
f32-accumulating twin by one rounding of the output (2e-2 abs + 1e-2
rel for bf16, 2e-3 for f16) — on the wgmma route P is also rounded to
16 bits before P V, which stays well inside that; f32 by the reordering
of f32 sums (1e-4), which also holds the tf32x3 route's three-way TF32
split products (~21 mantissa bits) and fails one TF32 product. Each flash case also checks which route's launch
counter moved.
The relayout kernel moves bytes only and must match bit for bit; each
relayout case checks which of its three routes (copy, staged, direct)
launched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.relayout import ops as R  # noqa: E402
from repro_torch.launch.serve import ServeConfig, Server  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float16: (2e-3, 2e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape,src,dst,dtype",
    [
        ((384, 8192), (1, 8192), (8, 8192), torch.bfloat16),  # paged KV
        ((2048, 192), (16, 8), (8, 8), torch.float32),
        ((256, 192), (64, 16), (16, 8), torch.float16),
        ((128, 64), (16, 8), (8, 16), torch.int8),
        ((64, 48), (8, 8), (16, 16), torch.float64),
        ((96, 24), (8, 3), (16, 1), torch.float32),  # 4-byte units
    ],
)
def test_relayout_kernel_matches_plain(cuda, shape, src, dst, dtype):
    dense = (torch.randn(shape, device=cuda) * 8).to(dtype)
    x = R.dense_to_blocked(dense, src)
    before = R.relayout.launches
    got = R.relayout(x, shape, src, dst)
    want = R.relayout_ref(x, shape, src, dst)
    torch.cuda.synchronize()
    assert R.relayout.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))


def test_relayout_kernel_unaligned_input(cuda):
    """A contiguous view 2 bytes past an aligned base: the wrapper takes
    the direct route with a narrower unit, and the bytes still match."""
    base = torch.randn(1 + 32 * 64, device=cuda).to(torch.bfloat16)
    x = base[1:].reshape(4, 8, 8, 8)  # (32, 64) blocked (8, 8)
    before = dict(R.relayout.launches_by_route)
    got = R.relayout(x, (32, 64), (8, 8), (16, 16))
    want = R.relayout_ref(x, (32, 64), (8, 8), (16, 16))
    torch.cuda.synchronize()
    assert _moved(before) == {"copy": 0, "staged": 0, "direct": 1}
    assert torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))


def _moved(before):
    return {r: n - before[r] for r, n in R.relayout.launches_by_route.items()}


RELAYOUT_DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", RELAYOUT_DTYPES)
@pytest.mark.parametrize(
    "shape,src,dst,offset,route",
    [
        ((384, 256), (1, 256), (8, 256), 0, "copy"),  # paged KV
        ((96, 40), (16, 8), (16, 8), 0, "copy"),  # equal blockings
        ((24, 201), (1, 201), (8, 201), 0, "copy"),  # a byte tail at int8
        ((15, 9), (5, 3), (5, 3), 0, "copy"),  # under one block of units, and a tail
        ((2048, 192), (16, 8), (8, 8), 0, "staged"),  # the paper's layouts
        ((2048, 192), (16, 8), (64, 16), 0, "staged"),
        ((2048, 192), (8, 8), (16, 16), 0, "staged"),
        ((256, 192), (64, 16), (16, 8), 0, "staged"),
        ((96, 24), (8, 3), (16, 1), 0, "staged"),  # 4-byte-or-narrower pieces
        ((96, 48), (8, 6), (16, 2), 0, "staged"),
        ((64, 48), (8, 8), (16, 16), 1, "direct"),  # misaligned by one element
        ((16, 8192), (2, 8192), (8, 4096), 0, "direct"),  # super-tile beyond shared memory
    ],
)
def test_relayout_route_matches_plain(cuda, shape, src, dst, offset, route, dtype):
    """Each route at element sizes 1, 2, 4 and 8, bit for bit, with the
    route's launch counter moving by one."""
    M, N = shape
    n = M * N
    base = (torch.randn(n + offset, device=cuda) * 8).to(dtype)
    x = base[offset:].view(M // src[0], N // src[1], *src)
    before = dict(R.relayout.launches_by_route)
    got = R.relayout(x, shape, src, dst)
    want = R.relayout_ref(x, shape, src, dst)
    torch.cuda.synchronize()
    assert _moved(before) == {r: int(r == route) for r in before}
    assert torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))


@pytest.mark.parametrize(
    "shape,src,dst,dtype",
    [
        ((9684, 28), (4, 4), (1, 4), torch.float32),
        ((1296, 208), (2, 1), (1, 16), torch.int8),
        ((432, 208), (1, 16), (2, 4), torch.bfloat16),
        ((144, 208), (2, 1), (2, 4), torch.float64),
    ],
)
def test_relayout_staged_partial_line_matches_plain(cuda, shape, src, dst, dtype):
    """Staged tiles whose last 128-byte line is partial, under a swizzle
    other than the identity (the plan is pinned in
    test_torch_relayout.py), bit for bit on the staged route."""
    M, N = shape
    x = (torch.randn(M * N, device=cuda) * 8).to(dtype).view(M // src[0], N // src[1], *src)
    before = dict(R.relayout.launches_by_route)
    got = R.relayout(x, shape, src, dst)
    want = R.relayout_ref(x, shape, src, dst)
    torch.cuda.synchronize()
    assert _moved(before) == {"copy": 0, "staged": 1, "direct": 0}
    assert torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))


@pytest.mark.parametrize(
    "shape,src,dst,route",
    [((65552, 32768), (16, 8), (8, 8), "staged"), ((65552, 32768), (1, 32768), (8, 32768), "copy")],
)
def test_relayout_over_2_31_bytes_in_bands(cuda, shape, src, dst, route):
    """An int8 transform of just over 2^31 bytes a side: two launches,
    each indexing in 32 bits, and every byte matches."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(-128, 128, (shape[0] // src[0], shape[1] // src[1]) + src,
                      dtype=torch.int8, device=cuda, generator=gen)
    before = dict(R.relayout.launches_by_route)
    got = R.relayout(x, shape, src, dst)
    torch.cuda.synchronize()
    assert _moved(before) == {r: 2 * int(r == route) for r in before}
    want = R.relayout_ref(x, shape, src, dst)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "B,H,Hkv,S,D,dtype,causal,window,blocks",
    [
        (1, 32, 4, 512, 128, torch.bfloat16, True, None, (512, 512)),  # yi-6b prefill
        (2, 4, 2, 384, 64, torch.float32, True, 48, (128, 128)),
        (1, 4, 4, 200, 64, torch.float32, False, 100, (200, 200)),  # ragged vs 64-row tiles
        (1, 8, 2, 256, 80, torch.bfloat16, True, None, (256, 256)),
        (2, 4, 1, 96, 16, torch.float16, True, None, (96, 96)),
        (1, 4, 2, 128, 192, torch.bfloat16, False, None, (64, 64)),
        (1, 2, 1, 128, 256, torch.float32, True, 7, (128, 128)),
    ],
)
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, S, D, dtype, causal, window, blocks):
    q = torch.randn((B, H, S, D), device=cuda).to(dtype)
    k = torch.randn((B, Hkv, S, D), device=cuda).to(dtype)
    v = torch.randn((B, Hkv, S, D), device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, block_q=blocks[0], block_k=blocks[1])
    before = FA.flash_attention.launches
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    route = FA._route(dtype, D)
    by_route[route] += 1
    assert FA.flash_attention.launches_by_route == by_route
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


_BF16 = torch.bfloat16


@pytest.mark.parametrize(
    "B,H,Hkv,S,D,dtype,causal,window",
    [
        # head dims on the tensor-core route (D is padded to a multiple of 64)
        (1, 4, 2, 256, 64, _BF16, True, None),
        (1, 4, 2, 256, 80, _BF16, True, None),
        (1, 4, 2, 256, 128, _BF16, True, None),
        (1, 2, 1, 128, 256, _BF16, True, None),
        # ragged S (not a multiple of the 64-row tiles), causal and window 48
        *[(1, 4, 1, S, 128, _BF16, True, w) for S in (200, 300, 449) for w in (None, 48)],
        (1, 4, 2, 300, 64, _BF16, False, 48),
        # GQA groups 1, 4 and 8
        (1, 4, 4, 192, 128, _BF16, True, None),
        (2, 8, 2, 192, 128, _BF16, True, None),
        (1, 8, 1, 192, 128, _BF16, True, None),
        # f16, the smallest head dim
        (2, 4, 1, 96, 16, torch.float16, True, None),
        # S <= 64: one tile, with and without the causal mask
        (1, 4, 2, 48, 64, _BF16, True, None),
        (1, 2, 2, 64, 128, _BF16, False, None),
    ],
)
def test_flash_wgmma_route_matches_plain(cuda, B, H, Hkv, S, D, dtype, causal, window):
    """The tensor-core kernel against the plain twin; only the wgmma
    counter moves."""
    q = torch.randn((B, H, S, D), device=cuda).to(dtype)
    k = torch.randn((B, Hkv, S, D), device=cuda).to(dtype)
    v = torch.randn((B, Hkv, S, D), device=cuda).to(dtype)
    assert FA._route(dtype, D) == "wgmma"
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    by_route["wgmma"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# the flash kernel's shapes on one rank of a TP prefill of 4 x 512-token
# prompts: (B, H/TP, Hkv_local, S, D), Hkv_local the rank's block of the
# KV heads (yi-6b at TP = 2 and 4, and on (data=2, model=2) with its 2
# rows; jamba-v0.1-52b at TP = 2 and 4), or one selected KV head per
# query head where the TP size does not divide them (starcoder2-3b's 2
# KV heads at TP = 4); then the same ranks' slot admission of one
# 256-token prompt (yi-6b and jamba-v0.1-52b at TP = 2 and 4)
TP_RANK_SHAPES = [(4, 16, 2, 512, 128), (4, 8, 1, 512, 128), (2, 16, 2, 512, 128),
                  (4, 16, 4, 512, 128), (4, 8, 2, 512, 128), (4, 6, 6, 512, 128),
                  (1, 16, 2, 256, 128), (1, 16, 4, 256, 128), (1, 8, 1, 256, 128),
                  (1, 8, 2, 256, 128)]


@pytest.mark.parametrize("B,H,Hkv,S,D", TP_RANK_SHAPES)
def test_flash_wgmma_at_tp_rank_shapes(cuda, B, H, Hkv, S, D):
    """The bf16 tensor-core kernel at the shapes a TP rank's prefill
    gives it, against the plain twin; only the wgmma counter moves."""
    q, k, v = (torch.randn((B, h, S, D), device=cuda).to(_BF16) for h in (H, Hkv, Hkv))
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=True)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    by_route["wgmma"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    assert got.shape == q.shape and torch.isfinite(got).all()
    atol, rtol = TOL[_BF16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("S,causal,window", [(160, True, None), (333, True, 48),
                                             (449, False, None)])
@pytest.mark.parametrize("dtype", [_BF16, torch.float16])
@pytest.mark.parametrize("D", [8, 24, 40, 200, 248])
def test_flash_16bit_odd_head_dim_takes_wgmma(cuda, D, dtype, S, causal, window):
    """16-bit head dims of 8 mod 16: the tensor-core kernel, D padded
    with TMA's zeros to a multiple of 64 and only D columns stored."""
    q = torch.randn((1, 4, S, D), device=cuda).to(dtype)
    k = torch.randn((1, 2, S, D), device=cuda).to(dtype)
    v = torch.randn((1, 2, S, D), device=cuda).to(dtype)
    assert FA._route(dtype, D) == "wgmma"
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    by_route["wgmma"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


_F32 = torch.float32


def _low_mantissa_v(shape, device):
    """V just below TF32's rounding midpoint above 1 (1 + 2^-11 - k 2^-22,
    k in 1..128): every hi part is 1 and the lo part carries ~2^-11, so
    a kernel that drops the lo products is off by ~4.7e-4 everywhere,
    beyond 1e-4 (tests/test_torch_flash.py shows it on the CPU)."""
    k = torch.randint(1, 129, shape, device=device).float()
    return 1 + (2048 - k) * 2.0 ** -22


@pytest.mark.parametrize(
    "B,H,Hkv,S,D,causal,window,values",
    [
        # head dims 8, 40, 64, 128 (D <= 64 pads to 64, the rest to 128)
        (1, 4, 2, 256, 8, True, None, "normal"),
        (1, 4, 2, 256, 40, True, None, "normal"),
        (1, 4, 2, 256, 64, True, None, "normal"),
        (1, 4, 2, 256, 128, True, None, "normal"),
        (1, 2, 1, 192, 72, True, None, "normal"),
        # the serve prefill shape in f32
        (1, 32, 4, 512, 128, True, None, "normal"),
        # ragged S (not a multiple of 64 nor of 32), causal, window, none
        *[(1, 4, 1, S, 128, True, w) + ("normal",) for S in (97, 333, 449) for w in (None, 48)],
        (1, 4, 2, 333, 64, False, 48, "normal"),
        (1, 4, 2, 200, 40, False, None, "normal"),
        (1, 4, 4, 100, 128, False, 100, "normal"),
        # GQA groups 1, 4, 8 and B > 1
        (2, 4, 4, 192, 128, True, None, "normal"),
        (2, 8, 2, 192, 128, True, None, "normal"),
        (3, 8, 1, 160, 64, True, 7, "normal"),
        # S <= 32: one kv tile
        (1, 4, 2, 24, 64, True, None, "normal"),
        # V below TF32's last bit: only the lo products get it right
        (1, 4, 2, 256, 64, True, None, "low_mantissa"),
        (2, 8, 2, 333, 128, True, 48, "low_mantissa"),
        (1, 4, 1, 200, 40, False, None, "low_mantissa"),
    ],
)
def test_flash_tf32x3_route_matches_plain(cuda, B, H, Hkv, S, D, causal, window, values):
    """The 3xTF32 tensor-core kernel against the f32 plain twin (TF32
    off for the twin's products) at the f32 tolerance; only the tf32x3
    counter moves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.randn((B, H, S, D), device=cuda)
    k = torch.randn((B, Hkv, S, D), device=cuda)
    if values == "low_mantissa":
        v = _low_mantissa_v((B, Hkv, S, D), cuda)
    else:
        v = torch.randn((B, Hkv, S, D), device=cuda)
    assert FA._route(_F32, D) == "tf32x3"
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    by_route["tf32x3"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    assert got.dtype == _F32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol, rtol = TOL[_F32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "B,H,Hkv,S,causal,window,values",
    [
        (1, 4, 2, 160, True, None, "normal"),
        (2, 8, 2, 333, True, 48, "normal"),  # GQA 4, B > 1, ragged S, window
        (1, 4, 1, 449, False, None, "normal"),
        (2, 4, 4, 333, False, 48, "low_mantissa"),
        (1, 2, 1, 24, True, None, "normal"),  # one kv tile
    ],
)
@pytest.mark.parametrize("D", [136, 192, 200, 256])
def test_flash_f32_beyond_128_takes_tf32x3(cuda, D, B, H, Hkv, S, causal, window, values):
    """f32 head dims above 128: the tf32x3 kernel as a cluster of two
    blocks splitting the head dim, at the f32 tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.randn((B, H, S, D), device=cuda)
    k = torch.randn((B, Hkv, S, D), device=cuda)
    if values == "low_mantissa":
        v = _low_mantissa_v((B, Hkv, S, D), cuda)
    else:
        v = torch.randn((B, Hkv, S, D), device=cuda)
    assert FA._route(_F32, D) == "tf32x3"
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    by_route["tf32x3"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    assert got.dtype == _F32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol, rtol = TOL[_F32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_flash_wgmma_route_rejects_misaligned(cuda):
    """TMA needs 16-byte aligned bases: a view 2 bytes in raises."""
    base = torch.randn(1 + 2 * 64 * 64, device=cuda).to(_BF16)
    q = base[1:].reshape(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention(q, q, q)


def test_flash_wgmma_route_rejects_misaligned_odd_head_dim(cuda):
    """D = 40 takes the TMA route too, so a view 2 bytes in raises."""
    base = torch.randn(1 + 2 * 64 * 40, device=cuda).to(_BF16)
    q = base[1:].reshape(1, 2, 64, 40)
    with pytest.raises(ValueError, match="wgmma route needs 16-byte aligned"):
        FA.flash_attention(q, q, q)


def test_flash_tf32x3_route_rejects_misaligned(cuda):
    """The f32 tensor-core route loads by TMA too: a view 4 bytes in raises."""
    base = torch.randn(1 + 2 * 64 * 64, device=cuda)
    q = base[1:].reshape(1, 2, 64, 64)
    with pytest.raises(ValueError, match="tf32x3 route needs 16-byte aligned"):
        FA.flash_attention(q, q, q)


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.randn((1, 2, 64, 12), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q)
    q = torch.randn((1, 2, 64, 16), device=cuda)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="divisible"):
        FA.flash_attention(q, q, q, block_q=48)


def test_server_on_cuda_goes_through_both_kernels(cuda):
    """A smoke-size server on the card: both kernels launch on the main
    path, and its prefill logits agree with the CPU path's."""
    cfg = dataclasses.replace(C.get_smoke_config("yi-6b"), attn_impl="flash")
    sc = ServeConfig(batch=2, prompt_len=24, max_seq=48, replicas=3, page_size=8)
    server = Server(sc, device=cuda, model_cfg=cfg)
    R.relayout.launches = FA.flash_attention.launches = 0
    R.relayout.launches_by_route = dict.fromkeys(R.ROUTES, 0)
    FA.flash_attention.launches_by_route = dict.fromkeys(FA.ROUTES, 0)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    server.register_prefix(prefix)
    reqs = [server.submit(np.concatenate([prefix, rng.integers(0, 256, 4)]), 4),
            server.submit(rng.integers(0, 256, 20), 4)]
    out = server.run(reqs)
    assert out["served"] == 2 and all(len(r.out) == 4 for r in reqs)
    assert R.relayout.launches == 3 and FA.flash_attention.launches > 0
    assert R.relayout.launches_by_route == {"copy": 3, "staged": 0, "direct": 0}
    assert FA.flash_attention.launches_by_route == {
        **dict.fromkeys(FA.ROUTES, 0), "wgmma": FA.flash_attention.launches}

    cpu_params = map_tree(lambda t: t.cpu(), server.params)
    toks = torch.as_tensor(reqs[1].prompt)[None]
    lg, _ = T.prefill(server.params, cfg, {"tokens": toks.to(cuda)}, sc.max_seq)
    lc, _ = T.prefill(cpu_params, cfg, {"tokens": toks}, sc.max_seq)
    err = float((lg.cpu() - lc).abs().max())
    assert err <= 5e-2 * float(lc.abs().max())


# -- the training path on the card: wire numerics, executor, reduction --


def _rings(L, K, seed):
    perm = np.random.default_rng(seed).permutation(L)
    S = L // K
    return tuple(tuple(int(d) for d in perm[i * S:(i + 1) * S]) for i in range(K))


@pytest.mark.parametrize("scale_pow", [-30, -6, 0, 6, 30])
def test_quantize_on_cuda_is_bitexact_to_numpy(cuda, scale_pow):
    """The int8 wire format on the card equals the numpy twin of
    ``chainwrite_ref._quantize_ref`` bit for bit, whole-tensor and per
    row, including half-way values and subnormal scales."""
    from repro_torch.core.chainwrite_ref import _quantize_ref
    from repro_torch.runtime.compression import quantize, quantize_rows

    rng = np.random.default_rng(scale_pow + 100)
    x = (rng.standard_normal((6, 257)) * 10.0 ** scale_pow).astype(np.float32)
    x[0, :8] = [0.0, -0.0, 1.5, -2.5, 0.5, 127.5, -126.5, 3.0]
    x[1] = 0.0
    q, s = quantize(torch.from_numpy(x).to(cuda))
    qr, sr = _quantize_ref(x)
    assert np.array_equal(q.cpu().numpy(), qr) and np.float32(s.item()) == sr
    qs, ss = quantize_rows(torch.from_numpy(x).to(cuda))
    for d in range(x.shape[0]):
        qd, sd = _quantize_ref(x[d])
        assert np.array_equal(qs[d].cpu().numpy(), qd)
        assert ss[d].cpu().numpy().view(np.uint32) == np.float32(sd).view(np.uint32)


_WIRED = ("all_reduce_rs_ag", "all_reduce_rotation", "all_to_all")
_EXECUTOR_CASES = [
    (c, k, w)
    for c in _WIRED + ("reduce_scatter", "all_gather", "broadcast")
    for k in (1, 2, 4)
    for w in ((None, "int8") if c in _WIRED else (None,))
]


@pytest.mark.parametrize("collective,K,wire", _EXECUTOR_CASES)
def test_executor_on_cuda_equals_cpu(cuda, collective, K, wire):
    """Every collective on the card is ``torch.equal`` to the same call
    on the CPU (and so to the numpy oracle the CPU tests pin), for both
    wires; the byte counter matches the model on the card too."""
    from repro_torch.core import chainwrite as cw

    L = 8
    rings = _rings(L, K, K)
    rng = np.random.default_rng(7)

    def run(dev):
        if collective.startswith("all_reduce"):
            x = torch.from_numpy(rng.standard_normal((L, 37, 3)).astype(np.float32))
            return cw.multi_chain_all_reduce(x.to(dev), rings, algo=collective[11:],
                                             wire_dtype=wire)
        if collective == "all_to_all":
            x = torch.from_numpy(rng.standard_normal((L, L, 5)).astype(np.float32))
            return cw.multi_chain_all_to_all(x.to(dev), rings, wire_dtype=wire)
        if collective == "reduce_scatter":
            x = torch.from_numpy(rng.standard_normal((L, L, 5)).astype(np.float32))
            return cw.multi_chain_reduce_scatter(x.to(dev), rings)
        if collective == "all_gather":
            x = torch.from_numpy(rng.standard_normal((L, 6, 2)).astype(np.float32))
            return cw.multi_chain_all_gather(x.to(dev), rings, tiled=True)
        x = torch.from_numpy(rng.standard_normal((L, 12)).astype(np.float32))
        chains = [c for c in rings if 0 not in c] or [tuple(d for d in rings[0] if d)]
        return cw.multi_chain_broadcast(x.to(dev), 0, chains, num_frames=3)

    cw.wire_counter.reset()
    rng = np.random.default_rng(7)
    got = run(cuda)
    assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes()
    rng = np.random.default_rng(7)
    want = run(torch.device("cpu"))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("wire,ef", [(None, False), ("int8", True)])
def test_bucketed_reduce_on_cuda(cuda, wire, ef):
    """Bucketed == per-leaf bit for bit on the card at the exact wire,
    and the card's reduction (EF residuals included) equals the CPU's."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives as col

    mesh = make_host_mesh(data=4)
    rng = np.random.default_rng(3)
    shapes = [(33, 7), (5,), (128, 64), (1000,), (3, 3, 3)]
    stacked = [torch.from_numpy(rng.standard_normal((4,) + s).astype(np.float32))
               for s in shapes]
    res = [torch.from_numpy(rng.standard_normal((4,) + s).astype(np.float32) * 1e-3)
           for s in shapes]
    outs = {}
    for label, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        for bucket in (None, 4096):
            red = col.make_stacked_reduce(mesh, num_chains=2, wire_dtype=wire,
                                          error_feedback=ef, bucket_bytes=bucket)
            st = [s.clone().to(dev) for s in stacked]
            rs = [r.clone().to(dev) for r in res] if ef else None
            outs[label, bucket] = ([g.cpu() for g in red(st, rs)],
                                      [r.cpu() for r in rs] if ef else None)
    for bucket in (None, 4096):
        g_card, r_card = outs["card", bucket]
        g_cpu, r_cpu = outs["cpu", bucket]
        assert all(torch.equal(a, b) for a, b in zip(g_card, g_cpu))
        if ef:
            assert all(torch.equal(a, b) for a, b in zip(r_card, r_cpu))
    if wire is None:
        assert all(torch.equal(a, b) for a, b in zip(outs["card", None][0],
                                                     outs["card", 4096][0]))


def test_kernels_refuse_autograd_on_cuda(cuda):
    """Neither kernel has a backward: under autograd the wrappers raise
    on the card, as they do on the CPU, instead of returning an output
    without a grad_fn; under no_grad they launch."""
    q = torch.randn((1, 2, 64, 16), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, q, q)
    with torch.no_grad():
        assert FA.flash_attention(q, q, q).shape == q.shape
    x = R.dense_to_blocked(torch.randn((16, 16), device=cuda), (8, 8)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        R.relayout(x, (16, 16), (8, 8), (16, 16))
    with torch.no_grad():
        R.relayout(x, (16, 16), (8, 8), (16, 16))


def test_train_step_on_cuda_matches_cpu(cuda):
    """A smoke-size Torrent train step on the card (4 virtual ranks,
    int8 wire with EF, buckets) gives the CPU step's loss within bf16
    noise, and its executor bytes equal the byte model's."""
    from repro_torch.core import chainwrite as cw
    from repro_torch.data.pipeline import MarkovSource
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel.collectives import ef_residual_init

    cfg = C.get_smoke_config("yi-6b")
    batch_np = MarkovSource(cfg.vocab_size, 32, 8, seed=1).batch(0)
    losses = {}
    for label, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        params = map_tree(lambda t: t.to(dev), T.model_init(
            torch.Generator().manual_seed(0), cfg, "cpu"))
        step = make_train_step(cfg, adamw.OptConfig(), collectives="torrent",
                               num_chains=2, compress_grads=True, error_feedback=True,
                               bucket_bytes=1 << 14, mesh=make_host_mesh(data=4),
                               loss_chunks=2)
        batch = {k: torch.from_numpy(v.copy()).to(dev) for k, v in batch_np.items()}
        cw.wire_counter.reset()
        _, _, _, m = step(params, adamw.init(params), ef_residual_init(params, 4), batch)
        assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes()
        losses[label] = float(m["loss"])
    assert abs(losses["card"] - losses["cpu"]) < 2e-3, losses


def test_trainer_on_cuda_restarts_and_tracks_cpu(cuda, tmp_path):
    """The Trainer's own loop on the card (4 virtual ranks, Torrent K = 2,
    int8 wire with EF, buckets) with a failure injected at step 13: one
    restart, the state (EF residuals included) checkpointed from the
    card and restored onto it, and every step's loss within 5e-3 of the
    same run on the CPU from the same params (bf16 rounding order;
    measured 1.2e-3 on an H100)."""
    from repro_torch.launch.train import TrainConfig, Trainer

    base = dict(arch="yi-6b", smoke=True, steps=20, global_batch=8, seq_len=32,
                peak_lr=2e-3, warmup_steps=5, ckpt_every=10, loss_chunks=2, log_every=100,
                collectives="torrent", num_chains=2, compress_grads=True,
                bucket_bytes=1 << 16, dp=4, fail_at=(13,))
    init = T.model_init(torch.Generator().manual_seed(0), C.get_smoke_config("yi-6b"), "cpu")
    out, trainers = {}, {}
    for dev in ("cuda", "cpu"):
        trainers[dev] = Trainer(TrainConfig(ckpt_dir=str(tmp_path / dev), **base),
                                device=dev, params=init)
        out[dev] = trainers[dev].run()
    card = out["cuda"]
    assert (card["final_step"], card["restarts"]) == (20, 1)
    assert len(card["losses"]) == len(out["cpu"]["losses"]) == 23  # steps 10-12 replayed
    assert np.isfinite(card["losses"]).all() and card["last_loss"] < card["first_loss"]
    diff = max(abs(a - b) for a, b in zip(card["losses"], out["cpu"]["losses"]))
    assert diff < 5e-3, (card["losses"], out["cpu"]["losses"])
    state = trainers["cuda"].state
    assert all(t.device.type == "cuda" for t in leaves(state))
    assert any(float(r.abs().max()) > 0 for r in leaves(state["ef"]))


# -- MoE serving on the card ------------------------------------------------


@pytest.mark.parametrize("path,K,wire", [("flat", 1, None), ("rowwise", 1, None),
                                         ("ep", 1, None), ("ep", 2, None),
                                         ("ep", 1, "int8"), ("ep", 2, "int8")])
def test_moe_on_cuda_matches_cpu(cuda, path, K, wire):
    """The MoE paths at smoke size on the card against the same calls on
    the CPU: the routing (f32, TF32 off) picks the same experts, so the
    outputs differ only by bf16 rounding of the expert products (2e-2,
    the JAX tests' bound) — on the int8 wire plus one int8 step of the
    largest expert output, where the two devices' results round to
    neighbouring steps of the return's quantization — and the aux by f32
    sums in another order; the executor's bytes equal the byte model's."""
    from repro_torch.core import chainwrite as cw
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), capacity_factor=8.0,
                              moe_row_dispatch=path == "rowwise")
    params = M.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 4, 64))
                         .astype(np.float32)).to(torch.bfloat16)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        p, xd = map_tree(lambda t: t.to(dev), params), x.to(dev)
        cw.wire_counter.reset()
        if path == "ep":
            o, a = M.moe_apply_ep(p, xd.reshape(8, 1, 4, 64), cfg, num_chains=K,
                                  wire_dtype=wire)
        else:
            o, a = M.moe_apply(p, xd, cfg)
        assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes()
        outs[dev.type] = (o.reshape(x.shape).cpu().float(), float(a))
    (og, ag), (oc, ac) = outs["cuda"], outs["cpu"]
    atol = 2e-2
    if wire:
        xe = x.reshape(1, 32, 64).expand(cfg.num_experts, 32, 64)
        atol += float(M._experts(xe, params["wg"], params["wu"], params["wd"]).abs().max()) / 127
    assert torch.allclose(og, oc, atol=atol, rtol=2e-2), float((og - oc).abs().max())
    assert abs(ag - ac) <= 1e-5 * abs(ac)


def test_moe_server_on_cuda_goes_through_both_kernels(cuda):
    """A deepseek-moe-16b smoke server on the card (MHA, layer 0 dense,
    then MoE): prefill takes the wgmma flash route, the prefix pages the
    relayout's copy route, and every request is served."""
    cfg = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), attn_impl="flash")
    sc = ServeConfig(arch="deepseek-moe-16b", batch=2, prompt_len=24, max_seq=48,
                     replicas=3, page_size=8)
    server = Server(sc, device=cuda, model_cfg=cfg)
    R.relayout.launches = FA.flash_attention.launches = 0
    R.relayout.launches_by_route = dict.fromkeys(R.ROUTES, 0)
    FA.flash_attention.launches_by_route = dict.fromkeys(FA.ROUTES, 0)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    server.register_prefix(prefix)
    reqs = [server.submit(np.concatenate([prefix, rng.integers(0, 256, 4)]), 4),
            server.submit(rng.integers(0, 256, 20), 4)]
    out = server.run(reqs)
    assert out["served"] == 2 and all(len(r.out) == 4 for r in reqs)
    assert R.relayout.launches_by_route == {"copy": 3, "staged": 0, "direct": 0}
    assert FA.flash_attention.launches > 0 and FA.flash_attention.launches_by_route == {
        **dict.fromkeys(FA.ROUTES, 0), "wgmma": FA.flash_attention.launches}


# -- MLA serving and expert parallelism in the train step on the card -----


def _close_to_scale(got, want, rel=5e-2):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * scale, (float((got - want).abs().max()), scale)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_prefill_and_decode_on_cuda_match_cpu(cuda, absorb):
    """deepseek-v2-lite-16b smoke (MLA with the compressed ``ckv``/
    ``krope`` cache, layer 0 dense, then MoE): a prefill and three
    per-slot decode steps on the card, with ``mla_absorb`` off and on,
    against the same calls on the CPU from the same params. The card's
    MoE layers are routed as the CPU's chose (``tests/_moe_routing.py``),
    so the two differ only by bf16 rounding: logits and cache rows within
    5e-2 of their scale (``tests/test_torch_model.py``'s bounds)."""
    from _moe_routing import recorded_routing, routing_as

    cfg = dataclasses.replace(C.get_smoke_config("deepseek-v2-lite-16b"), mla_absorb=absorb)
    params = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int32))
    pos = torch.tensor([12, 9], dtype=torch.int32)
    runs = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev), params)
        ctx = routing_as(runs[0][2]) if runs else recorded_routing()
        with torch.no_grad(), ctx as seen:
            logits, cache = T.prefill(p, cfg, {"tokens": toks.to(dev)}, 24)
            outs, cur = [logits], toks[:, -1].to(dev)
            for step in range(3):
                logits, cache = T.decode_step(p, cfg, cur, (pos + step).to(dev), cache)
                outs.append(logits)
                cur = logits.argmax(-1).to(torch.int32)
        runs.append((outs, cache, seen))
    (cpu, pcache, _), (card, ccache, _) = runs
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and torch.isfinite(a).all()
        _close_to_scale(a, b)
    assert {k for g in ccache["layers"] for q in g for k in q} == {"ckv", "krope"}
    for a, b in zip(leaves(ccache), leaves(pcache)):
        _close_to_scale(a, b)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_mamba2_prefill_and_decode_on_cuda_match_cpu(cuda, arch):
    """The Mamba-2 mixer at smoke size (G = 1 and G = 2 groups): a
    prefill over two and a half chunks and three decode steps on the
    card, against the same calls on the CPU from the same params:
    outputs and the conv/ssm cache within 5e-2 of their scale
    (``tests/test_torch_model.py``'s bounds). Then ``dt_bias = 20``,
    where exp(Λ_i − Λ_j) above the diagonal would overflow f32: the
    card's forward and grads are finite and its output agrees with the
    CPU's."""
    from repro_torch.models import mamba2 as M

    cfg = C.get_smoke_config(arch)
    params = M.mamba2_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    runs = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev), params)
        with torch.no_grad():
            y, cache = M.mamba2_prefill(p, x[:, :20].to(dev), cfg)
            outs = [y]
            for t in range(20, 23):
                y, cache = M.mamba2_decode(p, x[:, t : t + 1].to(dev), cache, cfg)
                outs.append(y)
        runs.append((outs, cache))
    (cpu, ccache), (card, gcache) = runs
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and torch.isfinite(a).all()
        _close_to_scale(a, b)
    for k in ("conv", "ssm"):
        assert gcache[k].dtype == ccache[k].dtype
        _close_to_scale(gcache[k], ccache[k])

    hot = {**params, "dt_bias": torch.full_like(params["dt_bias"], 20.0)}
    outs = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.detach().to(dev).requires_grad_(True), hot)
        y = M.mamba2_apply(p, x.to(dev).float(), cfg)
        grads = torch.autograd.grad(y.float().square().sum(), leaves(p))
        assert torch.isfinite(y).all() and all(torch.isfinite(g).all() for g in grads)
        outs.append(y.detach())
    _close_to_scale(outs[1], outs[0])


def test_jamba_server_on_cuda_launches_flash_per_prefill(cuda):
    """A jamba-v0.1-52b smoke server on the card (mamba and GQA layers,
    dense and MoE FFNs): ``register_prefix`` refuses the mamba cache and
    pages nothing, every request is served, and the flash kernel
    launches once per prefill and GQA layer, all on the wgmma route."""
    cfg = dataclasses.replace(C.get_smoke_config("jamba-v0.1-52b"), attn_impl="flash")
    sc = ServeConfig(arch="jamba-v0.1-52b", batch=2, prompt_len=24, max_seq=48, replicas=3,
                     page_size=8)
    server = Server(sc, device=cuda, model_cfg=cfg)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="per-position"):
        server.register_prefix(rng.integers(0, cfg.vocab_size, 16).astype(np.int32))
    assert server.prefix_cache.entries == [] and server.kv_multicast_log == []
    R.relayout.launches = FA.flash_attention.launches = 0
    R.relayout.launches_by_route = dict.fromkeys(R.ROUTES, 0)
    FA.flash_attention.launches_by_route = dict.fromkeys(FA.ROUTES, 0)
    reqs = [server.submit(rng.integers(0, 256, n), 4) for n in (20, 13, 9)]
    out = server.run(reqs)
    assert out["served"] == 3 and all(len(r.out) == 4 for r in reqs)
    gqa = sum(cfg.layer_spec(i).mixer == "gqa" for i in range(cfg.num_layers))
    assert gqa == 1 and R.relayout.launches == 0
    assert FA.flash_attention.launches == len(reqs) * gqa
    assert FA.flash_attention.launches_by_route == {
        **dict.fromkeys(FA.ROUTES, 0), "wgmma": len(reqs) * gqa}


def test_ep_train_step_on_cuda_matches_cpu(cuda):
    """Expert parallelism inside the train step at smoke size
    (deepseek-moe-16b with ``moe_ep_dispatch``, 4 virtual ranks, K = 2
    EP rings): every rank's grads from the joint forward and backward on
    the card against the CPU's, the card routed as the CPU chose (each
    rank's grads within 5% of each leaf's largest element, cosine >=
    0.999), then one Torrent step (K = 2, int8 + EF) whose loss is the
    CPU step's within 2e-3; the executor's bytes equal the byte model's."""
    from _moe_routing import recorded_routing, routing_as

    from repro_torch.core import chainwrite as cw
    from repro_torch.data.pipeline import MarkovSource
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_joint_grad_fn, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel.collectives import ef_residual_init

    cfg = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), moe_ep_dispatch=True,
                              moe_ep_chains=2)
    mesh = make_host_mesh(data=4)
    params = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch_np = MarkovSource(cfg.vocab_size, 16, 8, seed=1).batch(0)
    grads, losses, routing = [], [], None
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev), params)
        batch = {k: torch.from_numpy(v.copy()).to(dev) for k, v in batch_np.items()}
        ctx = recorded_routing() if routing is None else routing_as(routing)
        cw.wire_counter.reset()
        with ctx as seen:
            stacked, _ = make_joint_grad_fn(cfg, mesh, remat="none", loss_chunks=2)(p, batch)
            step = make_train_step(cfg, adamw.OptConfig(), collectives="torrent", num_chains=2,
                                   compress_grads=True, error_feedback=True, mesh=mesh,
                                   remat="none", loss_chunks=2)
            _, _, _, m = step(p, adamw.init(p), ef_residual_init(p, 4), batch)
        assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes() > 0
        routing = routing if routing is not None else list(seen)
        grads.append([g.cpu().double() for g in stacked])
        losses.append(float(m["loss"]))
    assert abs(losses[1] - losses[0]) < 2e-3, losses
    for w, g in zip(*grads):
        for r in range(4):
            a, b = g[r], w[r]
            assert torch.isfinite(a).all()
            assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())
            assert float((a * b).sum() / ((a * a).sum() * (b * b).sum()).sqrt()) >= 0.999


def test_apply_mrope_on_cuda_matches_cpu(cuda):
    """M-RoPE at qwen2-vl-7b's head dim and sections on the card against
    the CPU, with three distinct position streams: the same f32 angles,
    so within 1e-5 in f32 and one bf16 rounding in bf16."""
    from repro_torch.models.layers import apply_mrope

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 40, 28, 128)).astype(np.float32))
    pos = torch.from_numpy(np.stack([rng.integers(0, 40, (2, 40)), rng.integers(0, 900, (2, 40)),
                                     rng.integers(0, 5000, (2, 40))]).astype(np.int32))
    for dtype, (atol, rtol) in ((torch.float32, (1e-5, 1e-5)), (torch.bfloat16, (1e-2, 8e-3))):
        want = apply_mrope(x.to(dtype), pos, 1e6, (16, 24, 24))
        got = apply_mrope(x.to(dtype).to(cuda), pos.to(cuda), 1e6, (16, 24, 24))
        assert got.device.type == "cuda" and got.dtype == dtype
        torch.testing.assert_close(got.cpu().float(), want.float(), atol=atol, rtol=rtol)


def test_qwen2vl_flash_prefill_on_cuda_matches_cpu(cuda):
    """qwen2-vl-7b smoke (M-RoPE, qkv bias): a flash prefill of a
    vision-language batch (embeds, image-then-text positions) and three
    scalar-position decode steps on the card against the same calls on
    the CPU (the kernel's plain twin): logits and cache rows within 5e-2
    of their scale; the flash kernel launches once per layer, all on
    the wgmma route."""
    cfg = dataclasses.replace(C.get_smoke_config("qwen2-vl-7b"), attn_impl="flash")
    params = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    i = torch.arange(16)
    img = torch.stack([torch.zeros_like(i), i // 4, i % 4])
    t = 4 + torch.arange(16)
    pos = torch.cat([img, t.expand(3, 16)], 1).to(torch.int32)[:, None].expand(3, 2, 32)
    embeds = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    runs = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda x: x.to(dev), params)
        FA.flash_attention.launches = 0
        FA.flash_attention.launches_by_route = dict.fromkeys(FA.ROUTES, 0)
        with torch.no_grad():
            logits, cache = T.prefill(p, cfg, {"embeds": embeds.to(dev),
                                               "positions": pos.contiguous().to(dev)}, 40)
            outs, cur = [logits], logits.argmax(-1).to(torch.int32)
            for step in range(3):
                logits, cache = T.decode_step(p, cfg, cur, torch.tensor(32 + step,
                                                                        dtype=torch.int32), cache)
                outs.append(logits)
                cur = logits.argmax(-1).to(torch.int32)
        runs.append((outs, cache, dict(FA.flash_attention.launches_by_route)))
    (cpu, pcache, _), (card, ccache, routes) = runs
    assert routes == {**dict.fromkeys(FA.ROUTES, 0), "wgmma": cfg.num_layers}
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and torch.isfinite(a).all()
        _close_to_scale(a, b)
    for a, b in zip(leaves(ccache), leaves(pcache)):
        _close_to_scale(a, b)


def test_whisper_prefill_and_decode_on_cuda_match_cpu(cuda):
    """whisper-tiny smoke (encoder over 24 frames, cross-attention, GeLU
    FFNs, learned positions): a prefill and three per-slot decode steps
    on the card against the same calls on the CPU: logits, the layer
    caches and the ``enc`` leaf within 5e-2 of their scale; no kernel
    launch (reference attention)."""
    cfg = C.get_smoke_config("whisper-tiny")
    params = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.tensor([12, 9], dtype=torch.int32)
    FA.flash_attention.launches = R.relayout.launches = 0
    runs = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda x: x.to(dev), params)
        with torch.no_grad():
            logits, cache = T.prefill(p, cfg, {"tokens": toks.to(dev),
                                               "enc_frames": frames.to(dev)}, 24)
            outs, cur = [logits], toks[:, -1].to(dev)
            for step in range(3):
                logits, cache = T.decode_step(p, cfg, cur, (pos + step).to(dev), cache)
                outs.append(logits)
                cur = logits.argmax(-1).to(torch.int32)
        runs.append((outs, cache))
    (cpu, pcache), (card, ccache) = runs
    assert FA.flash_attention.launches == R.relayout.launches == 0
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and torch.isfinite(a).all()
        _close_to_scale(a, b)
    assert ccache["enc"].dtype == torch.bfloat16
    for a, b in zip(leaves(ccache), leaves(pcache)):
        _close_to_scale(a, b)


def test_process_form_executor_on_one_card(cuda):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device), each frame staged through pinned host memory: every rank's
    result of the executor's cases (K = 1 rings at both wires, the
    broadcast at F = 1 and 3) equals the stacked executor's row on the
    card bit for bit, and each rank's bytes their model."""
    import _dist_cases as dc
    from repro_torch.launch.dist import spawn

    cases = dc.cases(2, Ks=(1,), seeds=(0,), full=False)
    ranks = spawn(dc.executor_rank, 2, backend="gloo", device="cuda", timeout_s=300,
                  args=(cases,))
    for c in cases:
        want = dc.run_stacked(c, torch.from_numpy(dc.global_input(c, 2)).to(cuda))
        for r, rank in enumerate(ranks):
            row, sent, model, _ = rank[c["name"]]
            assert torch.equal(torch.from_numpy(row).to(cuda), want[r]), (c["name"], r)
            assert sent == model


def test_tp_ops_on_one_card_match_cpu(cuda):
    """The tensor-parallel conjugate ops (``copy_to_tp``,
    ``reduce_from_tp``, ``gather_from_tp``) and the vocab-parallel CE on
    two gloo ranks sharing the card (each collective staged through the
    host) against the same ranks on the CPU: outputs and grads within
    1e-6, the CE's sums within 1e-5 relative."""
    import _tp_cases as tc
    from repro_torch.launch.dist import spawn

    got = spawn(tc.ops_world, 2, backend="gloo", device="cuda", timeout_s=300)
    want = spawn(tc.ops_world, 2, backend="gloo", device="cpu", timeout_s=300)
    for g, w in zip(got, want):
        for op in ("copy", "reduce", "gather"):
            for a, b in zip(g[op], w[op]):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
        for a, b in zip(g["ce"][:2], w["ce"][:2]):
            assert abs(a - b) <= 1e-5 * abs(b)
        np.testing.assert_allclose(g["ce"][2], w["ce"][2], atol=1e-6, rtol=1e-5)


def test_tp_gated_norm_and_moe_split_on_one_card(cuda):
    """Two gloo ranks sharing the card on a ``(data=1, model=2)`` mesh:
    Mamba-2's gated norm with its sum of squares over the model group,
    and a MoE layer (flat and rowwise) with its experts and shared-expert
    columns split over it, against the unsplit function on the same
    card: outputs and grads within 1e-5 relative (f32 compute; they
    differ by the order of f32 sums)."""
    import _tp_family_cases as fc
    from repro_torch.launch.dist import spawn

    ranks = spawn(fc.card_world, 2, backend="gloo", device="cuda", timeout_s=300)
    k = fc.NORM_SHAPE[-1] // 2
    for r in ranks:
        i = r["coord"]
        whole = r["norm_whole"]
        for key in ("y", "dx", "dz"):
            np.testing.assert_allclose(r["norm"][key], whole[key][..., i * k:(i + 1) * k],
                                       atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(r["norm"]["dscale"], whole["dscale"][i * k:(i + 1) * k],
                                   atol=1e-6, rtol=1e-5)
        for path in ("flat", "rowwise"):
            got, want = r["moe"][f"{path}/split"], r["moe"][f"{path}/whole"]
            assert abs(got["aux"] - want["aux"]) <= 1e-6 * abs(want["aux"])
            for key in ("y", "dx", "drouter", "dwg"):
                scale = np.abs(want[key]).max()
                assert np.abs(got[key] - want[key]).max() <= 1e-5 * scale, (path, key)
