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
from repro_torch.tree import map_tree  # noqa: E402

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


def test_flash_16bit_odd_head_dim_takes_simt(cuda):
    """bf16 with D = 40 (a multiple of 8, not of 16): the CUDA-core kernel."""
    q = torch.randn((1, 4, 160, 40), device=cuda).to(_BF16)
    k = torch.randn((1, 2, 160, 40), device=cuda).to(_BF16)
    v = torch.randn((1, 2, 160, 40), device=cuda).to(_BF16)
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    by_route["simt"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


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


@pytest.mark.parametrize("D", [136, 192, 256])
def test_flash_f32_beyond_128_takes_simt(cuda, D):
    """f32 head dims above TF32X3_MAX_D: the CUDA-core kernel."""
    q = torch.randn((1, 4, 160, D), device=cuda)
    k = torch.randn((1, 2, 160, D), device=cuda)
    v = torch.randn((1, 2, 160, D), device=cuda)
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    by_route["simt"] += 1
    assert FA.flash_attention.launches_by_route == by_route
    atol, rtol = TOL[_F32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_flash_wgmma_route_rejects_misaligned(cuda):
    """TMA needs 16-byte aligned bases: a view 2 bytes in raises."""
    base = torch.randn(1 + 2 * 64 * 64, device=cuda).to(_BF16)
    q = base[1:].reshape(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
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
