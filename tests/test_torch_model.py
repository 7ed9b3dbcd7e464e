"""The port's dense-GQA decoder against ``repro.models`` with the same
weights (carried across by ``params_from_numpy``), on the yi-6b and
llama3-8b smoke configs.

Tolerances (bf16 compute at every matmul boundary, as in the JAX
package): the two frameworks round the same bf16 graph at different
places — XLA may keep f32 between fused ops, PyTorch rounds after each
op, and matmuls sum in other orders — so values differ by a few bf16
ulps and the differences grow through the layers. Logits must agree
within 5% of the logit scale (``LOGIT_REL``), cache
rows within 0.05 abs/rel (the JAX package's own bound for bf16 cache
rows computed along two paths, ``tests/test_serve_kv_multicast.py``).
Layer 0's K/V cache rows see identical inputs and must match bit for
bit. A wrong mask, position or head mapping moves logits by O(scale).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ["yi-6b", "llama3-8b"]
LOGIT_REL = 5e-2
CACHE_TOL = 5e-2
MAX_SEQ = 24


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _logits_close(got, want):
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= LOGIT_REL * np.abs(want).max(), (err, np.abs(want).max())


def _caches_close(tcache, jcache, exact_layer0=False):
    jl, tl = jax.tree.leaves(jcache["layers"]), leaves(tcache["layers"])
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t), _np(j), atol=CACHE_TOL, rtol=CACHE_TOL)
        if exact_layer0:
            np.testing.assert_array_equal(_np(t)[0], _np(j)[0])


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_params_layout_matches_jax(model):
    """Same nesting, leaf order, shapes and dtypes as the JAX params — so
    the weight byte stream is the same on both sides."""
    jcfg, tcfg, jp, _ = model
    ours = TT.model_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    jl = jax.tree.leaves(jp)
    tl = leaves(ours)
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl]
    assert all(t.dtype == torch.float32 for t in tl)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths[:3] == ["['embed']['table']", "['final_norm']['scale']",
                         "['groups'][0][0]['ffn']['down']"]


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
def test_prefill_logits_and_cache_match(model, impl):
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, attn_chunk=8)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl, attn_chunk=8)
    toks = _tokens(jcfg, 2, 16, seed=1)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    tl, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    assert tl.shape == (2, jcfg.vocab_size) and tl.dtype == torch.float32
    _logits_close(tl, jl)
    _caches_close(tc, jc, exact_layer0=True)


@pytest.mark.parametrize("per_slot", [True, False])
def test_decode_steps_match(model, per_slot):
    """Prefill, then three decode steps — with a (B,) per-slot position
    vector (continuous batching) or a scalar position."""
    jcfg, tcfg, jp, tp = model
    S = 12
    toks = _tokens(jcfg, 2, S, seed=2)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    _, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    if per_slot:  # row 1 is 3 positions behind row 0
        pos = np.array([S, S - 3], np.int32)
    cur = toks[:, -1]
    for step in range(3):
        p = pos + step if per_slot else np.int32(S + step)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(cur), jnp.asarray(p), jc)
        tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(cur.copy()), torch.as_tensor(p), tc)
        _logits_close(tl, jl)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _caches_close(tc, jc)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_apply_matches_jax(model, causal):
    """Full-sequence GQA without a cache (the training/prefill mixer)."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA

    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(6).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jlayer = jax.tree.map(lambda t: t[0], jp["groups"][0][0]["mixer"])
    tlayer = TT._index(tp["groups"][0][0]["mixer"], 0)
    want = JA.gqa_apply(jlayer, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), jcfg,
                        causal=causal)
    got = TA.gqa_apply(tlayer, torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(pos.copy()), tcfg, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=CACHE_TOL, rtol=CACHE_TOL)


def test_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(  # f32 path: bit-exact
        _np(TL.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5)),
        _np(JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)),
    )
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 11, dtype=np.int32), (2, 8))
    np.testing.assert_allclose(
        _np(TL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos.copy()), 5e5)),
        _np(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 5e5)), atol=1e-5, rtol=1e-5,
    )
    table = rng.standard_normal((32, 64)).astype(np.float32)
    ids = np.array([[0, 31, 7]], np.int32)
    np.testing.assert_array_equal(
        _np(TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids))),
        _np(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))),
    )
    ffn = {k: rng.standard_normal(s).astype(np.float32) * 0.1
           for k, s in (("gate", (64, 96)), ("up", (64, 96)), ("down", (96, 64)))}
    np.testing.assert_allclose(
        _np(TL.swiglu({k: torch.from_numpy(v) for k, v in ffn.items()}, tx)),
        _np(JL.swiglu({k: jnp.asarray(v) for k, v in ffn.items()}, jx)),
        atol=CACHE_TOL, rtol=CACHE_TOL,
    )


def test_params_from_numpy_keeps_bf16_bits_and_nesting():
    a = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    tree = {"w": np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), "l": [[{"b": a}]]}
    out = params_from_numpy(tree, "cpu")
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy(),
                                  tree["w"].view(np.int16))
    assert torch.equal(out["l"][0][0]["b"], torch.from_numpy(a))


@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-2.7b", "whisper-tiny",
             "qwen2-vl-7b", "jamba-v0.1-52b"]
)
def test_unported_branches_raise(arch):
    with pytest.raises(NotImplementedError):
        TT.model_init(torch.Generator().manual_seed(0), TC.get_smoke_config(arch), "cpu")


def test_entry_points_default_to_cuda():
    """With no card, an entry point that is not told ``device="cpu"``
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TC.get_smoke_config("yi-6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.model_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
