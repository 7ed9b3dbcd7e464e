"""The port's encoder-decoder (whisper-tiny) against ``repro.models``
with the same weights: ``gelu_mlp`` (the tanh form), ``layernorm``,
``unembed``, ``cross_attn_apply``, the encoder (``encode``, smoke
``encoder_seq_len`` 24), learned positions, ``forward_hidden``,
``loss_fn`` and its grads, ``prefill`` with the ``enc`` cache leaf,
scalar and per-slot ``decode_step``, the prefill and serve step
builders, and the Torrent train step over 4 virtual DP ranks.

Tolerances: the f32 layer functions within 1e-5 of their scale (both
packages compute the same f32 ops; ``gelu_mlp`` on f32 activations is
also held within 1e-5, which the exact-erf GeLU misses by ~1e-4, so the
test tells the two forms apart); bf16 layer functions within one bf16
rounding (0.05 abs/rel, ``tests/test_torch_model.py``'s bound). The
model-level bounds are ``tests/test_torch_model.py``'s and
``tests/test_torch_train.py``'s: logits within 5% of the logit scale,
cache rows within 0.05, the ``enc`` leaf within 0.05 of its scale (it
is the output of the encoder's layers), loss within 1e-3, each grad
leaf within 5% of its largest element with cosine >= 0.999.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.collectives import ef_residual_init, torrent_grad_reduce  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402
from repro_torch.tree import paths as tree_paths  # noqa: E402

ARCH = "whisper-tiny"
LOGIT_REL = 5e-2
CACHE_TOL = 5e-2
MAX_SEQ = 24


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close_to_scale(got, want, rel):
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _grads_close(got, want):
    g, w = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    if not w.any():
        assert not g.any()
        return
    assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()
    assert (g * w).sum() / np.sqrt((g * g).sum() * (w * w).sum()) >= 0.999


def _both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _batch(cfg, B=2, S=12, seed=1, labels=False):
    """Token prompts and bf16 frame embeddings (the stub frontend's
    input, random from ``seed``) as both packages take them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    jf, tf = _both(frames, "bfloat16")
    jb = {"tokens": jnp.asarray(toks), "enc_frames": jf}
    tb = {"tokens": torch.from_numpy(toks), "enc_frames": tf}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    p = {"fc1": rng.standard_normal((64, 96)) * 0.3, "b1": rng.standard_normal(96) * 0.5,
         "fc2": rng.standard_normal((96, 64)) * 0.1, "b2": rng.standard_normal(64) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jx, tx = _both(x, dtype)
    want = JL.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jx)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = TL.gelu_mlp(tp, tx)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got), _np(want), atol=CACHE_TOL, rtol=CACHE_TOL)
        return
    _close_to_scale(got, want, 1e-5)
    # the exact-erf GeLU (PyTorch's default) is another function
    h = torch.nn.functional.gelu(TL.matmul(tx, tp["fc1"]) + TL.cast(tp["b1"]))
    erf = TL.matmul(h, tp["fc2"]) + TL.cast(tp["b2"])
    assert np.abs(_np(erf) - _np(want)).max() > 1e-5 * np.abs(_np(want)).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 64)) * 4 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    init = TL.layernorm_init(64, "cpu")
    assert torch.equal(init["scale"], torch.ones(64)) and torch.equal(init["bias"], torch.zeros(64))
    jx, tx = _both(x, dtype)
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jx)
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, tx)
    assert got.dtype == tx.dtype
    tol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 8e-3)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol[0], rtol=tol[1])


def test_unembed_matches_jax():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 64)).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    got = TL.unembed({"table": torch.from_numpy(table)}, tx)
    want = JL.unembed({"table": jnp.asarray(table)}, jx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 50)
    _close_to_scale(got, want, 1e-5)


def test_cross_attn_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    (jx, tx), (je, te) = _both(x, "bfloat16"), _both(enc, "bfloat16")
    jl = jax.tree.map(lambda t: t[0], jp["groups"][0][0]["cross"])
    tl = TT._index(tp["groups"][0][0]["cross"], 0)
    want = JA.cross_attn_apply(jl, jx, je, jcfg)
    got = TA.cross_attn_apply(tl, tx, te, tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=CACHE_TOL, rtol=CACHE_TOL)


def test_encode_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg)

    def groups(cfg):
        return [([dataclasses.asdict(s) for s in p], r) for p, r in cfg.layer_groups()]

    enc_cfg = TT.encoder_config(tcfg)
    assert groups(enc_cfg) == groups(JT.encoder_config(jcfg))
    assert enc_cfg.pos_scheme == "learned" and enc_cfg.num_layers == tcfg.encoder_layers
    assert not any(s.cross_attention for p, _ in enc_cfg.layer_groups() for s in p)
    want = JT.encode(jp, jcfg, jb["enc_frames"])
    with torch.no_grad():
        got = TT.encode(tp, tcfg, tb["enc_frames"])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close_to_scale(got, want, CACHE_TOL)


def test_params_layout_matches_jax(model):
    jcfg, tcfg, jp, _ = model
    ours = TT.model_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [tuple(t.shape) for t in leaves(ours)] == [x.shape for x in jax.tree.leaves(jp)]
    assert all(t.dtype == torch.float32 for t in leaves(ours))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == ["".join(f"[{k!r}]" for k in p) for p, _ in tree_paths(ours)]
    for key in ("['pos_emb']", "['encoder']['pos_emb']", "['cross']['wq']", "['ffn']['fc1']",
                "['norm_ca']['scale']"):
        assert any(key in p for p in paths), key


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_forward_loss_and_grads_match_jax(model, remat):
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg, labels=True)
    jh, _ = JT.forward_hidden(jp, jcfg, jb, remat=remat)
    th, _ = TT.forward_hidden(tp, tcfg, tb, remat=remat)
    np.testing.assert_allclose(_np(th), _np(jh), atol=CACHE_TOL, rtol=CACHE_TOL)
    (jl, _), jg = jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, jb, remat=remat),
                                     has_aux=True)(jp)
    tg, tm = TS.make_grad_fn(tcfg, remat=remat)(tp, tb)
    assert abs(float(jl) - float(tm["loss"])) < 1e-3
    for a, g in zip(jax.tree.leaves(jg), leaves(tg)):
        _grads_close(g, a)


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
def test_prefill_logits_and_cache_match(model, impl):
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, attn_chunk=8)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl, attn_chunk=8)
    jb, tb = _batch(jcfg)
    jl, jc = JT.prefill(jp, jcfg, jb, MAX_SEQ)
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tcfg, tb, MAX_SEQ)
    assert tl.shape == (2, jcfg.vocab_size) and tl.dtype == torch.float32
    _close_to_scale(tl, jl, LOGIT_REL)
    assert sorted(tc) == ["enc", "layers"]
    assert tc["enc"].dtype == torch.bfloat16 and tuple(tc["enc"].shape) == jc["enc"].shape
    _close_to_scale(tc["enc"], jc["enc"], CACHE_TOL)
    for j, t in zip(jax.tree.leaves(jc["layers"]), leaves(tc["layers"])):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t), _np(j), atol=CACHE_TOL, rtol=CACHE_TOL)
    for j, t in zip(jax.tree.leaves(jc["layers"][0][0]), leaves(tc["layers"][0][0])):
        np.testing.assert_array_equal(_np(t)[0], _np(j)[0])  # layer 0: one projection


def test_init_cache_matches_jax(model):
    jcfg, tcfg, _, _ = model
    jc = JT.init_cache(jcfg, 3, MAX_SEQ)
    tc = TT.init_cache(tcfg, 3, MAX_SEQ, "cpu")
    assert [tuple(t.shape) for t in leaves(tc)] == [x.shape for x in jax.tree.leaves(jc)]
    assert tuple(tc["enc"].shape) == (3, tcfg.encoder_seq_len, tcfg.d_model)
    assert not any(t.any() for t in leaves(tc))


@pytest.mark.parametrize("per_slot", [True, False])
def test_decode_steps_match(model, per_slot):
    """Prefill, then three decode steps with a (B,) per-slot position
    (row 1 three positions behind row 0) or a scalar one; each adds its
    learned position and attends to the ``enc`` leaf."""
    jcfg, tcfg, jp, tp = model
    S = 12
    jb, tb = _batch(jcfg, S=S, seed=2)
    _, jc = JT.prefill(jp, jcfg, jb, MAX_SEQ)
    with torch.no_grad():
        _, tc = TT.prefill(tp, tcfg, tb, MAX_SEQ)
    cur = np.asarray(jb["tokens"][:, -1])
    for step in range(3):
        p = np.array([S, S - 3], np.int32) + step if per_slot else np.int32(S + step)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(cur), jnp.asarray(p), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(cur.copy()), torch.as_tensor(p), tc)
        _close_to_scale(tl, jl, LOGIT_REL)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for j, t in zip(jax.tree.leaves(jc), leaves(tc)):
        np.testing.assert_allclose(_np(t), _np(j), atol=CACHE_TOL, rtol=CACHE_TOL)


def test_decode_follows_the_forward(model):
    """Each of three greedy decode steps against ``forward_hidden`` over
    the prompt plus the tokens generated so far (its last row through
    the head), and the scalar-position step against the per-slot one
    with every row at that position: bit for bit the same."""
    _, tcfg, _, tp = model
    _, tb = _batch(tcfg, S=10, seed=3)
    toks = tb["tokens"]
    with torch.no_grad():
        logits, cache = TT.prefill(tp, tcfg, tb, MAX_SEQ)
        for step in range(3):
            cur = logits.argmax(-1).to(torch.int32)
            toks = torch.cat([toks, cur[:, None]], 1)
            pos = toks.shape[1] - 1
            scalar, _ = TT.decode_step(tp, tcfg, cur, torch.tensor(pos, dtype=torch.int32),
                                       map_tree(torch.clone, cache))
            logits, cache = TT.decode_step(tp, tcfg, cur, torch.full((2,), pos, dtype=torch.int32),
                                           cache)
            assert torch.equal(scalar, logits)
            hidden, _ = TT.forward_hidden(tp, tcfg, {**tb, "tokens": toks})
            _close_to_scale(logits, TL.unembed(tp["lm_head"], hidden[:, -1]), LOGIT_REL)


def test_prefill_and_serve_steps_match_jax(model):
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg, seed=4)
    jl, jc = JS.make_prefill_step(jcfg, MAX_SEQ)(jp, jb)
    with torch.no_grad():
        tl, tc = TS.make_prefill_step(tcfg, MAX_SEQ)(tp, tb)
    _close_to_scale(tl, jl, LOGIT_REL)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.array([12, 12], np.int32)
    jn, _ = JS.make_serve_step(jcfg)(jp, jnp.asarray(cur), jnp.asarray(pos), jc)
    with torch.no_grad():
        tn, _ = TS.make_serve_step(tcfg)(tp, torch.from_numpy(cur.copy()),
                                         torch.from_numpy(pos), tc)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_torrent_train_step_dp4_matches_dp1_and_jax(model):
    """The Torrent gradient reduction (rs_ag, K = 2) over 4 virtual DP
    ranks (``sharding.batch_pspecs``: every leaf along axis 0, the
    frames too) against the whole batch's grads in one rank, and both
    against JAX's loss and grads on the whole batch; then one exact and
    one int8 + error-feedback train step."""
    jcfg, tcfg, jp, _ = model
    jb, tb = _batch(jcfg, B=8, seed=5, labels=True)
    specs = sharding.batch_pspecs(tcfg, TC.SHAPES["train_4k"])
    assert {k: sharding.batch_axis(s) for k, s in specs.items()} == {
        "tokens": 0, "enc_frames": 0, "labels": 0}
    (jl, _), jg = jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    grad_fn = TS.make_grad_fn(tcfg)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    g4, m4 = torrent_grad_reduce(grad_fn, make_host_mesh(data=4), specs, num_chains=2)(tp, tb)
    g1, m1 = grad_fn(tp, tb)
    assert abs(float(m4["loss"]) - float(m1["loss"])) < 1e-3
    assert abs(float(m1["loss"]) - float(jl)) < 1e-3
    for a, b, j in zip(leaves(g4), leaves(g1), jax.tree.leaves(jg)):
        _grads_close(a, _np(b))
        _grads_close(b, j)
    opt = adamw.OptConfig(peak_lr=1e-3, warmup_steps=1)
    for compress in (False, True):
        p = params_from_numpy(jax.device_get(jp), "cpu")
        step = TS.make_train_step(tcfg, opt, collectives="torrent", num_chains=2,
                                  compress_grads=compress, error_feedback=compress,
                                  mesh=make_host_mesh(data=4))
        state = (p, adamw.init(p)) + ((ef_residual_init(p, 4),) if compress else ())
        m = step(*state, tb)[-1]
        assert abs(float(m["loss"]) - float(jl)) < 1e-3
        assert all(torch.isfinite(t).all() for t in leaves(p))
        assert not torch.equal(p["encoder"]["pos_emb"], tp["encoder"]["pos_emb"])


def test_write_cache_slot_refuses_the_enc_leaf(model):
    _, tcfg, _, _ = model
    cache = TT.init_cache(tcfg, 2, MAX_SEQ, "cpu")
    with pytest.raises(ValueError, match="enc"):
        TS.write_cache_slot(cache, TT.init_cache(tcfg, 1, MAX_SEQ, "cpu"), 0)
