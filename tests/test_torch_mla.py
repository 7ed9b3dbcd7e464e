"""The port's MLA mixer (``repro_torch.models.attention.mla_*``) against
``repro.models.attention`` on the deepseek-v2-lite-16b smoke config
(d_model 64, 4 heads, kv_lora_rank 32, qk_nope 16, qk_rope 8, v_head
16), and the whole model's loss and grads.

Params come from the JAX initializer, inputs from numpy seeds; both
cross with ``params_from_numpy``. Tolerances: the projections run in
bf16 and the attention in f32 in both packages; XLA and PyTorch round
the bf16 products at other places and sum in other orders, so bf16
outputs agree within 5e-2 abs/rel (``tests/test_torch_model.py``'s cache
bound) and the f32 query/key pieces given the same bf16 input within
one bf16 ulp (2^-7 relative, 1e-2 abs). The chunked attend equals the
one-shot attend of the same package within 2e-2 (f32 online softmax
against the materialized one, each rounded once to bf16). Loss within
1e-3 and grads within 5% of each leaf's max element with cosine >=
0.999 (``tests/test_torch_train.py``'s bounds), the MoE layers routed
as JAX routed (``tests/_jax_moe_routing.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from _jax_moe_routing import NEAR_TIE, flip_margins, record_jax_routing  # noqa: E402
from _moe_routing import routing_as  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = 5e-2
ULP = (1e-2, 2 ** -7)
CHUNK_TOL = 2e-2
B, S, MAX_SEQ = 2, 12, 20


def _cfgs(**kw):
    return (dataclasses.replace(JC.get_smoke_config(ARCH), **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), **kw))


@pytest.fixture(scope="module")
def mla_params():
    jp = jax.device_get(JA.mla_init(jax.random.PRNGKey(0), JC.get_smoke_config(ARCH)))
    return jp, params_from_numpy(jp, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _pos(B=B, S=S, start=0):
    p = np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, S)).copy()
    return jnp.asarray(p), torch.from_numpy(p)


def test_init_layout_and_convert_carry_leaves_unchanged(mla_params):
    """``mla_init`` makes JAX's leaves (names, shapes, f32), and
    ``params_from_numpy`` carries JAX's MLA leaves bit for bit."""
    jp, tp = mla_params
    cfg = TC.get_smoke_config(ARCH)
    ours = TA.mla_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(ours) == sorted(jp) == ["w_dkv", "w_uk", "w_uv", "wo", "wq"]
    for k, v in jp.items():
        assert tuple(ours[k].shape) == v.shape and ours[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v)


def test_qkv_matches_jax(mla_params):
    """The query split, the compressed KV and both rope'd pieces."""
    jp, tp = mla_params
    jcfg, tcfg = _cfgs()
    jx, tx = _x((B, S, jcfg.d_model))
    (jpos, tpos) = _pos(start=3)
    want = JA._mla_qkv(jp, jx, jpos, jcfg)
    got = TA._mla_qkv(tp, tx, tpos, tcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), atol=ULP[0], rtol=ULP[1])


def _pieces(tp, tcfg, seed=2):
    """One set of (q_nope, q_rope, c, k_rope) in bf16 for both packages."""
    jx, tx = _x((B, S, tcfg.d_model), seed)
    jpos, tpos = _pos()
    t = TA._mla_qkv(tp, tx, tpos, tcfg)
    j = tuple(jnp.asarray(_np(v)).astype(jnp.bfloat16) for v in t)
    return j, t


@pytest.mark.parametrize("mask", ["none", "causal", "per_row", "prefix"])
def test_attend_masks_match_jax(mla_params, mask):
    """``_mla_attend`` on the same bf16 pieces with no mask, the 2-D
    causal mask, a per-row 3-D mask (rows of different lengths, as
    per-slot decode makes) and a 2-D mask over a prefix."""
    jp, tp = mla_params
    jcfg, tcfg = _cfgs()
    j, t = _pieces(tp, tcfg)
    rows, cols = np.arange(S)[:, None], np.arange(S)[None, :]
    m = {"none": None,
         "causal": cols <= rows,
         "per_row": np.stack([cols <= rows, (cols <= rows) & (cols < 7)]),
         "prefix": np.broadcast_to(cols < 5, (S, S))}[mask]
    want = JA._mla_attend(jp, *j, jcfg, None if m is None else jnp.asarray(m))
    got = TA._mla_attend(tp, *t, tcfg, None if m is None else torch.from_numpy(m.copy()))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("chunk", [4, 5, 64])
def test_attend_chunked_matches_jax_and_one_shot(mla_params, chunk):
    """The online-softmax attend over T chunks (5 does not divide T = 12
    and pads; 64 is one chunk) against JAX's chunked scan and against
    the port's one-shot attend under the causal mask."""
    jp, tp = mla_params
    jcfg, tcfg = _cfgs(attn_impl="chunked", attn_chunk=chunk)
    j, t = _pieces(tp, tcfg)
    got = TA._mla_attend_chunked(tp, *t, tcfg)
    _close(got, JA._mla_attend_chunked(jp, *j, jcfg))
    causal = torch.ones((S, S), dtype=torch.bool).tril()
    one_shot = TA._mla_attend(tp, *t, dataclasses.replace(tcfg, attn_impl="reference"), causal)
    _close(got, one_shot, CHUNK_TOL)
    # the chunked route is taken for a 2-D mask only
    assert torch.equal(TA._mla_attend(tp, *t, tcfg, causal), got)


@pytest.mark.parametrize("impl", ["reference", "chunked"])
@pytest.mark.parametrize("causal", [True, False])
def test_apply_matches_jax(mla_params, impl, causal):
    jp, tp = mla_params
    jcfg, tcfg = _cfgs(attn_impl=impl, attn_chunk=5)
    jx, tx = _x((B, S, jcfg.d_model), 3)
    jpos, tpos = _pos()
    _close(TA.mla_apply(tp, tx, tpos, tcfg, causal=causal),
           JA.mla_apply(jp, jx, jpos, jcfg, causal=causal))


def test_init_cache_and_prefill_match_jax(mla_params):
    """The compressed cache: ``ckv`` (B, T, r) and ``krope`` (B, T, dr)
    in bf16, zeros past the prompt; prefill's output and cache rows."""
    jp, tp = mla_params
    jcfg, tcfg = _cfgs()
    empty = TA.mla_init_cache(tcfg, B, MAX_SEQ, device="cpu")
    for k, v in JA.mla_init_cache(jcfg, B, MAX_SEQ).items():
        assert tuple(empty[k].shape) == v.shape and empty[k].dtype == torch.bfloat16
        assert not empty[k].any()
    jx, tx = _x((B, S, jcfg.d_model), 4)
    jpos, tpos = _pos()
    jo, jc = JA.mla_prefill(jp, jx, jpos, jcfg, MAX_SEQ)
    to, tc = TA.mla_prefill(tp, tx, tpos, tcfg, MAX_SEQ)
    _close(to, jo)
    assert sorted(tc) == sorted(jc) == ["ckv", "krope"]
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=ULP[0], rtol=ULP[1])
        assert not tc[k][:, S:].any()


@pytest.mark.parametrize("per_slot", [True, False])
def test_decode_absorbed_and_recovered_match_jax(mla_params, per_slot):
    """Three decode steps after a prefill, with scalar or per-slot
    positions, with ``mla_absorb`` off (recover K/V from the cache) and
    on (absorb the up-projections), each against JAX's same branch; the
    two branches agree with each other (the same math) on each side."""
    jp, tp = mla_params
    outs = {}
    for absorb in (False, True):
        jcfg, tcfg = _cfgs(mla_absorb=absorb)
        jx, tx = _x((B, S, jcfg.d_model), 5)
        jpos, tpos = _pos()
        _, jc = JA.mla_prefill(jp, jx, jpos, jcfg, MAX_SEQ)
        _, tc = TA.mla_prefill(tp, tx, tpos, tcfg, MAX_SEQ)
        # the port starts from JAX's cache, so each step sees one input
        tc = params_from_numpy(jax.device_get(jc), "cpu")
        steps = []
        for step in range(3):
            jd, td = _x((B, 1, jcfg.d_model), 10 + step)
            pos = np.array([S + step, S - 4 + step], np.int32) if per_slot else np.int32(S + step)
            jo, jc = JA.mla_decode(jp, jd, jnp.asarray(pos), jc, jcfg)
            to, tc = TA.mla_decode(tp, td, torch.as_tensor(pos), tc, tcfg)
            assert tuple(to.shape) == jo.shape == (B, 1, jcfg.d_model)
            _close(to, jo)
            steps.append((_np(jo), _np(to)))
        for k in jc:  # the new rows written where JAX writes them
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=ULP[0], rtol=ULP[1])
        outs[absorb] = steps
    for (j0, t0), (j1, t1) in zip(outs[False], outs[True]):
        np.testing.assert_allclose(j1, j0, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(t1, t0, atol=TOL, rtol=TOL)


def test_absorbed_decode_matches_jax_on_one_cache(mla_params):
    """``_mla_decode_absorbed`` alone, on one bf16 cache and query for
    both packages, scalar and per-row positions."""
    jp, tp = mla_params
    jcfg, tcfg = _cfgs(mla_absorb=True)
    rng = np.random.default_rng(6)
    H, r = jcfg.num_heads, jcfg.kv_lora_rank
    dn, dr = jcfg.qk_nope_head_dim, jcfg.qk_rope_head_dim
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, 1, H, dn), (B, 1, H, dr), (B, MAX_SEQ, r), (B, MAX_SEQ, dr))]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    for pos in (np.int32(9), np.array([9, 15], np.int32)):
        want = JA._mla_decode_absorbed(jp, *j, jnp.asarray(pos), jcfg)
        got = TA._mla_decode_absorbed(tp, *t, torch.as_tensor(pos), tcfg)
        _close(got, want)


@pytest.fixture(scope="module")
def model():
    jcfg = JC.get_smoke_config(ARCH)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("impl", ["reference", "chunked"])
def test_model_loss_and_grads_match_jax(model, impl, monkeypatch):
    """Training through MLA by autograd: ``loss_fn`` (with the MoE aux)
    and its grads against ``jax.value_and_grad``, the one-shot and the
    chunked attend."""
    jp, tp = model
    jcfg, tcfg = _cfgs(attn_impl=impl, attn_chunk=8)
    seen = record_jax_routing(monkeypatch)
    b = JD.MarkovSource(jcfg.vocab_size, 32, 4, seed=1).batch(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                             remat="none", loss_chunks=4), has_aux=True)(jp)
    jax.effects_barrier()
    assert len(seen) == 2  # the two MoE layers
    with routing_as([torch.from_numpy(np.array(e, np.int64)) for _, e in seen]) as flips:
        tg, tm = make_grad_fn(tcfg, remat="none", loss_chunks=4)(
            tp, {k: torch.from_numpy(v) for k, v in b.items()})
    margins = flip_margins(seen, flips)
    assert all(m <= NEAR_TIE for m in margins), margins
    assert abs(float(jl) - float(tm["loss"])) < 1e-3
    mixer = [p for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]
             if "mixer" in jax.tree_util.keystr(p)]
    # wq, w_dkv, w_uk, w_uv, wo of each group: dense layer 0, then 2 MoE
    # layers stacked
    assert len(mixer) == 2 * 5
    for a, g in zip(jax.tree.leaves(jg), leaves(tg)):
        a, g = np.asarray(a, np.float64), g.double().numpy()
        assert a.shape == g.shape and np.isfinite(g).all()
        assert np.abs(a - g).max() <= 5e-2 * np.abs(a).max()
        assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= 0.999


def test_model_cache_is_the_compressed_latent(model):
    """deepseek-v2-lite's decode cache holds ``ckv``/``krope`` per layer,
    ``kv_lora_rank + qk_rope_head_dim`` bf16 values a position: the
    KV-prefix payload per position is layers x (r + dr)."""
    from repro_torch.launch.paged_kv import kv_feature_width

    cfg = TC.get_smoke_config(ARCH)
    cache = TT.init_cache(cfg, 1, MAX_SEQ, device="cpu")
    assert {k for g in cache["layers"] for p in g for k in p} == {"ckv", "krope"}
    assert kv_feature_width(cache, MAX_SEQ) == cfg.num_layers * (
        cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    full = TC.get_config(ARCH)
    assert full.kv_lora_rank + full.qk_rope_head_dim == 576
