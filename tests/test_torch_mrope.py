"""The port's M-RoPE (Qwen2-VL's multimodal rotary embedding) and the
qwen2-vl-7b smoke model against ``repro.models`` with the same weights:
``apply_mrope``, GQA with three position streams, the vision-language
batch (precomputed ``embeds`` and ``positions`` (3, B, S)) through
``forward_hidden``, ``loss_fn`` and its grads, ``prefill`` and scalar
``decode_step``, the prefill and serve step builders, and the Torrent
train step whose DP split follows the batch axes ``sharding.batch_pspecs`` gives.

Positions follow Qwen2-VL's layout of an image followed by text: the
patches of a (1, gh, gw) grid at (0, i // gw, i % gw), then text tokens
whose three streams all run on from the grid's maximum + 1. Distinct
streams are the only inputs that show a wrong section map.

Tolerances: ``apply_mrope`` in f32 within 1e-5 (both compute the same
f32 angles; cos/sin may differ in the last bit); in bf16 within one
bf16 rounding of the output (8e-3 of |x| + 1e-2). The model-level
bounds are ``tests/test_torch_model.py``'s (bf16 rounding at different
places in XLA and PyTorch): logits within 5% of the logit scale, cache
rows within 0.05, layer 0's bf16 cache rows bit for bit, loss within
1e-3, each grad leaf within 5% of its largest element with cosine >=
0.999 (``tests/test_torch_train.py``).
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
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.tree import paths as tree_paths  # noqa: E402

ARCH = "qwen2-vl-7b"
LOGIT_REL = 5e-2
CACHE_TOL = 5e-2
MAX_SEQ = 24


def vl_positions(B: int, grid: tuple[int, int], text: int) -> np.ndarray:
    """(3, B, gh*gw + text) int32: an image of a (1, gh, gw) patch grid,
    then ``text`` tokens from the grid's maximum + 1 on all streams."""
    gh, gw = grid
    i = np.arange(gh * gw)
    img = np.stack([np.zeros_like(i), i // gw, i % gw])
    t = max(gh, gw) + np.arange(text)
    pos = np.concatenate([img, np.stack([t, t, t])], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, pos.shape[1])))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _logits_close(got, want, rel=LOGIT_REL):
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _grads_close(got, want):
    """One grad leaf within 5% of its largest element, cosine >= 0.999;
    a leaf the loss does not read (the token table under ``embeds``) is
    zero in both."""
    g, w = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    if not w.any():
        assert not g.any()
        return
    assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()
    assert (g * w).sum() / np.sqrt((g * g).sum() * (w * w).sum()) >= 0.999


def _batch(cfg, B=2, grid=(2, 4), text=8, seed=1, labels=False):
    """A vision-language batch as both packages take it: bf16 embeds of
    the patches and text tokens (random, from ``seed``) and their
    positions; with ``labels``, next-token labels for the loss."""
    rng = np.random.default_rng(seed)
    pos = vl_positions(B, grid, text)
    emb = rng.standard_normal((B, pos.shape[2], cfg.d_model)).astype(np.float32)
    jb = {"embeds": jnp.asarray(emb).astype(jnp.bfloat16), "positions": jnp.asarray(pos)}
    tb = {"embeds": torch.from_numpy(emb).to(torch.bfloat16),
          "positions": torch.from_numpy(pos)}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, pos.shape[1:]).astype(np.int32)
        jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
    return jb, tb


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax(sections, dtype):
    D = 2 * sum(sections)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, D)).astype(np.float32)
    pos = np.stack([rng.integers(0, 40, (2, 12)), rng.integers(0, 900, (2, 12)),
                    rng.integers(0, 5000, (2, 12))]).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = _np(JL.apply_mrope(jx, jnp.asarray(pos), 1e6, sections))
    got = TL.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == tx.dtype and tuple(got.shape) == x.shape
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 8e-3)
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=rtol)


def test_mrope_with_equal_streams_is_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 10, 4, 128)).astype(np.float32))
    p = torch.from_numpy(rng.integers(0, 3000, (2, 10)).astype(np.int32))
    got = TL.apply_mrope(x, p.expand(3, 2, 10), 1e6, (16, 24, 24))
    assert torch.equal(got, TL.apply_rope(x, p, 1e6))


@pytest.mark.parametrize("stream,lo,hi", [(0, 0, 16), (1, 16, 40), (2, 40, 64)])
def test_mrope_sections_are_contiguous_blocks(stream, lo, hi):
    """Moving one position stream rotates exactly its section's
    frequency slots (contiguous blocks of 16, 24 and 24 of the 64 at
    D = 128, in both halves), and leaves every other column as it was."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 6, 2, 128)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 50, (3, 1, 6)).astype(np.int32))
    moved = pos.clone()
    moved[stream] += 7
    a = TL.apply_mrope(x, pos, 1e6, (16, 24, 24))
    b = TL.apply_mrope(x, moved, 1e6, (16, 24, 24))
    changed = (a != b).any(0).any(0).any(0)
    want = torch.zeros(128, dtype=torch.bool)
    want[lo:hi] = want[64 + lo : 64 + hi] = True
    assert torch.equal(changed, want)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_apply_with_mrope_matches_jax(model, causal):
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg)
    jlayer = jax.tree.map(lambda t: t[0], jp["groups"][0][0]["mixer"])
    tlayer = TT._index(tp["groups"][0][0]["mixer"], 0)
    want = JA.gqa_apply(jlayer, jb["embeds"], jb["positions"], jcfg, causal=causal)
    got = TA.gqa_apply(tlayer, tb["embeds"], tb["positions"], tcfg, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=CACHE_TOL, rtol=CACHE_TOL)


def test_params_layout_matches_jax(model):
    jcfg, tcfg, jp, _ = model
    ours = TT.model_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [tuple(t.shape) for t in leaves(ours)] == [x.shape for x in jax.tree.leaves(jp)]
    assert all(t.dtype == torch.float32 for t in leaves(ours))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == ["".join(f"[{k!r}]" for k in p) for p, _ in tree_paths(ours)]
    assert any("['bq']" in p for p in paths) and not any("pos_emb" in p for p in paths)


def test_forward_loss_and_grads_match_jax(model):
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg, labels=True)
    jh, _ = JT.forward_hidden(jp, jcfg, jb)
    th, _ = TT.forward_hidden(tp, tcfg, tb)
    np.testing.assert_allclose(_np(th), _np(jh), atol=CACHE_TOL, rtol=CACHE_TOL)
    (jl, _), jg = jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    tg, tm = TS.make_grad_fn(tcfg)(tp, tb)
    assert abs(float(jl) - float(tm["loss"])) < 1e-3
    for a, g in zip(jax.tree.leaves(jg), leaves(tg)):
        _grads_close(g, a)
    assert not tg["embed"]["table"].any()


def test_image_positions_change_the_hidden_states(model):
    """The image layout against the same embeds at text positions
    (``arange`` on every stream): the hidden states move by O(scale)
    (measured 0.255 of it), so the positions reach the model. (Which
    stream feeds which slots is ``test_mrope_sections_are_contiguous_
    blocks``' check: at the smoke width's 8 slots, the height and width
    streams turn only low frequencies.)"""
    jcfg, tcfg, _, tp = model
    _, tb = _batch(jcfg)
    pos = tb["positions"]
    text = torch.arange(pos.shape[2], dtype=torch.int32).expand(pos.shape)
    with torch.no_grad():
        a, _ = TT.forward_hidden(tp, tcfg, tb)
        b, _ = TT.forward_hidden(tp, tcfg, {**tb, "positions": text})
    assert float((a - b).abs().max()) > 0.1 * float(b.abs().max())


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
    _logits_close(tl, jl)
    for j, t in zip(jax.tree.leaves(jc), leaves(tc)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t), _np(j), atol=CACHE_TOL, rtol=CACHE_TOL)
    for j, t in zip(jax.tree.leaves(jc["layers"][0][0]), leaves(tc["layers"][0][0])):
        np.testing.assert_array_equal(_np(t)[0], _np(j)[0])  # layer 0: one projection


def test_scalar_decode_steps_match(model):
    """Prefill, then three decode steps at a scalar position (all three
    streams at ``pos``, as JAX's M-RoPE decode takes it)."""
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg, seed=2)
    S = tb["positions"].shape[2]
    _, jc = JT.prefill(jp, jcfg, jb, MAX_SEQ)
    with torch.no_grad():
        _, tc = TT.prefill(tp, tcfg, tb, MAX_SEQ)
    cur = np.array([3, 250], np.int32)
    for step in range(3):
        p = np.int32(S + step)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(cur), jnp.asarray(p), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(cur.copy()), torch.as_tensor(p), tc)
        _logits_close(tl, jl)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for j, t in zip(jax.tree.leaves(jc), leaves(tc)):
        np.testing.assert_allclose(_np(t), _np(j), atol=CACHE_TOL, rtol=CACHE_TOL)


def test_decode_equals_a_longer_prefill(model):
    """The first decode step's logits against a reference prefill of the
    S + 1 rows (the embedded token appended, positions plus (S, S, S)):
    the decode path's positions and cache read what the prefill's do."""
    _, tcfg, _, tp = model
    _, tb = _batch(tcfg, seed=3)
    S = tb["positions"].shape[2]
    tok = torch.tensor([5, 77], dtype=torch.int32)
    with torch.no_grad():
        _, cache = TT.prefill(tp, tcfg, tb, MAX_SEQ)
        step, _ = TT.decode_step(tp, tcfg, tok, torch.tensor(S, dtype=torch.int32), cache)
        longer = {"embeds": torch.cat([tb["embeds"], TL.embed(tp["embed"], tok[:, None])], 1),
                  "positions": torch.cat([tb["positions"],
                                          torch.full((3, 2, 1), S, dtype=torch.int32)], 2)}
        full, _ = TT.prefill(tp, tcfg, longer, MAX_SEQ)
    _logits_close(step, full)


def test_prefill_and_serve_steps_match_jax(model):
    jcfg, tcfg, jp, tp = model
    jb, tb = _batch(jcfg, seed=4)
    S = tb["positions"].shape[2]
    jl, jc = JS.make_prefill_step(jcfg, MAX_SEQ)(jp, jb)
    with torch.no_grad():
        tl, tc = TS.make_prefill_step(tcfg, MAX_SEQ)(tp, tb)
    _logits_close(tl, jl)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jn, _ = JS.make_serve_step(jcfg)(jp, jnp.asarray(cur), jnp.int32(S), jc)
    with torch.no_grad():
        tn, _ = TS.make_serve_step(tcfg)(tp, torch.from_numpy(cur.copy()),
                                         torch.tensor(S, dtype=torch.int32), tc)
    assert tn.dtype == torch.int32 and tuple(tn.shape) == (2,)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_torrent_train_step_dp4_matches_dp1_and_jax(model):
    """The Torrent gradient reduction (rs_ag, K = 2) over 4 virtual DP
    ranks whose split follows ``sharding.batch_pspecs`` (positions along
    axis 1) against the grads of the whole batch in one rank, and both
    against JAX's loss and grads on the whole batch (equal-sized ranks'
    mean of means is the global mean); then one train step of each, and
    one of 2 ranks × 2 microbatches."""
    from repro_torch.parallel.collectives import torrent_grad_reduce

    jcfg, tcfg, jp, _ = model
    jb, tb = _batch(jcfg, B=8, seed=5, labels=True)
    specs = sharding.batch_pspecs(tcfg, TC.SHAPES["train_4k"])
    assert {k: sharding.batch_axis(s) for k, s in specs.items()} == {
        "embeds": 0, "positions": 1, "labels": 0}
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
    for dp, microbatches in ((4, 1), (1, 1), (2, 2)):  # microbatches split like ranks
        p = params_from_numpy(jax.device_get(jp), "cpu")
        step = TS.make_train_step(tcfg, opt, collectives="torrent", num_chains=2,
                                  mesh=make_host_mesh(data=dp),
                                  microbatches=microbatches)
        _, _, m = step(p, adamw.init(p), tb)
        assert abs(float(m["loss"]) - float(jl)) < 1e-3
        assert all(torch.isfinite(t).all() for t in leaves(p))
        assert not torch.equal(p["groups"][0][0]["mixer"]["wq"], tp["groups"][0][0]["mixer"]["wq"])
