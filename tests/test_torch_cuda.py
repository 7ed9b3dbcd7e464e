"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances for flash attention: bf16/f16 outputs may differ from the
f32-accumulating twin by one rounding of the output (2e-2 abs + 1e-2
rel for bf16, 2e-3 for f16); f32 by the reordering of f32 sums (1e-4).
The relayout kernel moves bytes only and must match bit for bit.
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
    """A contiguous view 2 bytes past an aligned base: the wrapper picks
    a narrower unit, and the bytes still match."""
    base = torch.randn(1 + 32 * 64, device=cuda).to(torch.bfloat16)
    x = base[1:].reshape(4, 8, 8, 8)  # (32, 64) blocked (8, 8)
    got = R.relayout(x, (32, 64), (8, 8), (16, 16))
    want = R.relayout_ref(x, (32, 64), (8, 8), (16, 16))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))


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
    got = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


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
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    server.register_prefix(prefix)
    reqs = [server.submit(np.concatenate([prefix, rng.integers(0, 256, 4)]), 4),
            server.submit(rng.integers(0, 256, 20), 4)]
    out = server.run(reqs)
    assert out["served"] == 2 and all(len(r.out) == 4 for r in reqs)
    assert R.relayout.launches == 3 and FA.flash_attention.launches > 0

    cpu_params = map_tree(lambda t: t.cpu(), server.params)
    toks = torch.as_tensor(reqs[1].prompt)[None]
    lg, _ = T.prefill(server.params, cfg, {"tokens": toks.to(cuda)}, sc.max_seq)
    lc, _ = T.prefill(cpu_params, cfg, {"tokens": toks}, sc.max_seq)
    err = float((lg.cpu() - lc).abs().max())
    assert err <= 5e-2 * float(lc.abs().max())
