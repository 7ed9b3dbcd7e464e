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
