"""The port's Mamba-2 SSD mixer (``repro_torch.models.mamba2``) and
``gated_rmsnorm`` against ``repro.models`` on the mamba2-2.7b smoke
config (G = 1 group) and the jamba-v0.1-52b one's mamba layers (G = 2),
and the two models' loss and grads.

Params come from the JAX initializer, inputs from numpy seeds; both
cross with ``params_from_numpy``. Tolerances:

* ``gated_rmsnorm``: f32 throughout, so f32 reordering (1e-6 rel); in
  bf16, one bf16 rounding of the output (2^-8 rel).
* ``_causal_conv``: an f32 sum of W = 4 products (1e-6); in bf16 the
  output is rounded once, so one bf16 ulp (2^-8 of the scale).
* the mixer: projections in bf16, the SSD in f32 in both packages. The
  bf16 output within 1e-2 of its scale (two bf16 ulps), the f32 state
  within 1e-3 of its scale, the conv window (raw bf16 projections) bit
  for bit.
* the port's chunked form against its own token-by-token recurrence
  (and the prefill → decode handoff): 3e-2 abs/rel, the JAX package's
  bound for the same check (``tests/test_models_smoke.py``): prefill
  rounds the conv output to bf16 before silu, decode does not.
* grads: within 5% of each leaf's max element with cosine >= 0.999
  (``tests/test_torch_train.py``'s bounds); losses within 1e-3; the
  whole jamba model's bf16 grads as its test says.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

from _jax_moe_routing import NEAR_TIE, flip_margins, record_jax_routing  # noqa: E402
from _moe_routing import routing_as  # noqa: E402

ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]
OUT_REL = 1e-2
STATE_REL = 1e-3
RECUR_TOL = 3e-2
GRAD_REL, GRAD_COS = 5e-2, 0.999
B = 2


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_smoke_config(arch), **kw),
            dataclasses.replace(TC.get_smoke_config(arch), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def mixer(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jax.device_get(JM.mamba2_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp, params_from_numpy(jp, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close_to_scale(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


def _x(shape, seed=1, scale=1.0, dtype="bf16"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _grads_close(got: list, want: list, rel=GRAD_REL, cos=GRAD_COS):
    assert len(got) == len(want)
    for g, a in zip(got, want):
        a, g = np.asarray(a, np.float64), g.double().numpy()
        assert a.shape == g.shape and np.isfinite(g).all()
        assert np.abs(a - g).max() <= rel * np.abs(a).max()
        assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= cos


def test_init_layout_matches_jax(mixer):
    """The port's initializer makes JAX's param names, shapes and dtypes."""
    jcfg, tcfg, jp, _ = mixer
    ours = TM.mamba2_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert sorted(ours) == sorted(jp) == sorted(
        ["in_z", "in_x", "in_BC", "in_dt", "conv_x_w", "conv_x_b", "conv_BC_w", "conv_BC_b",
         "dt_bias", "A_log", "D", "norm", "out_proj"])
    assert [tuple(t.shape) for t in leaves(ours)] == [x.shape for x in jax.tree.leaves(jp)]
    assert all(t.dtype == torch.float32 for t in leaves(ours))
    assert torch.equal(ours["A_log"], torch.zeros_like(ours["A_log"]))
    assert torch.equal(ours["D"], torch.ones_like(ours["D"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gated_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    scale = rng.standard_normal(64).astype(np.float32)
    jx, tx = _x((2, 8, 64), seed=4, dtype=dtype)
    jz, tz = _x((2, 8, 64), seed=5, dtype=dtype)
    want = JL.gated_rmsnorm({"scale": jnp.asarray(scale)}, jx, jz, 1e-5)
    got = TL.gated_rmsnorm({"scale": torch.from_numpy(scale)}, tx, tz, 1e-5)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_matches_jax(dtype):
    jx, tx = _x((2, 11, 24), seed=6, dtype=dtype)
    w = np.random.default_rng(7).standard_normal((4, 24)).astype(np.float32)
    b = np.random.default_rng(8).standard_normal(24).astype(np.float32)
    want = JM._causal_conv(jx, jnp.asarray(w), jnp.asarray(b))
    got = TM._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    else:
        _close_to_scale(got, want, 2 ** -8)
    # causal: the first output sees only the first input
    np.testing.assert_allclose(_np(got)[:, 0], (_np(tx)[:, 0] * w[3] + b), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("S", [2, 8, 20])  # tail padded; one chunk; padded multi-chunk
def test_prefill_output_and_cache_match_jax(mixer, S):
    jcfg, tcfg, jp, tp = mixer
    assert jcfg.ssm_chunk == 8
    jx, tx = _x((B, S, jcfg.d_model), seed=S)
    jo, jc = JM.mamba2_prefill(jp, jx, jcfg)
    to, tc = TM.mamba2_prefill(tp, tx, tcfg)
    assert to.dtype == torch.bfloat16 and to.shape == (B, S, jcfg.d_model)
    _close_to_scale(to, jo, OUT_REL)
    _close_to_scale(TM.mamba2_apply(tp, tx, tcfg), JM.mamba2_apply(jp, jx, jcfg), OUT_REL)
    assert tc["conv"].dtype == torch.bfloat16 and tc["ssm"].dtype == torch.float32
    assert tuple(tc["conv"].shape) == jc["conv"].shape
    np.testing.assert_array_equal(_np(tc["conv"]), _np(jc["conv"]))  # raw projections
    _close_to_scale(tc["ssm"], jc["ssm"], STATE_REL)


def test_decode_steps_from_jax_prefill_cache_match_jax(mixer):
    """Three decode steps from JAX's own prefill cache (carried across)."""
    jcfg, tcfg, jp, tp = mixer
    jx, tx = _x((B, 13, jcfg.d_model), seed=9)
    _, jc = JM.mamba2_prefill(jp, jx[:, :10], jcfg)
    tc = params_from_numpy(jax.device_get(jc), "cpu")
    for t in range(10, 13):
        jo, jc = JM.mamba2_decode(jp, jx[:, t : t + 1], jc, jcfg)
        to, tc = TM.mamba2_decode(tp, tx[:, t : t + 1], tc, tcfg)
        assert to.shape == (B, 1, jcfg.d_model)
        _close_to_scale(to, jo, OUT_REL)
    np.testing.assert_array_equal(_np(tc["conv"]), _np(jc["conv"]))
    _close_to_scale(tc["ssm"], jc["ssm"], STATE_REL)


def test_decode_writes_into_a_stacked_cache_in_place(mixer):
    """Decode through a layer's view of a stacked (reps, B, ...) cache
    updates the stack itself, as ``transformer.groups_decode`` needs."""
    _, tcfg, _, tp = mixer
    stacked = map_tree(lambda t: torch.stack([t, t]), TM.mamba2_init_cache(tcfg, B, device="cpu"))
    view = {k: v[1] for k, v in stacked.items()}
    _, tx = _x((B, 1, tcfg.d_model), seed=10)
    _, out = TM.mamba2_decode(tp, tx, view, tcfg)
    assert out["ssm"].data_ptr() == stacked["ssm"][1].data_ptr()
    assert stacked["ssm"][1].abs().sum() > 0 and stacked["conv"][1, :, -1].abs().sum() > 0
    assert stacked["ssm"][0].abs().sum() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_recurrence(arch):
    """Chunked SSD == the port's own token-by-token recurrence, over a
    padded multi-chunk sequence (``tests/test_models_smoke.py``'s check)."""
    _, cfg = _cfgs(arch)
    params = TM.mamba2_init(torch.Generator().manual_seed(0), cfg, "cpu")
    S = int(cfg.ssm_chunk * 2.5)
    _, x = _x((B, S, cfg.d_model), seed=11, scale=0.3, dtype="f32")
    full = TM.mamba2_apply(params, x, cfg)
    cache = TM.mamba2_init_cache(cfg, B, device="cpu")
    seq = torch.cat([TM.mamba2_decode(params, x[:, t : t + 1], cache, cfg)[0]
                     for t in range(S)], 1)
    np.testing.assert_allclose(_np(full), _np(seq), atol=RECUR_TOL, rtol=RECUR_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_state_handoff(arch):
    """prefill(x[:S]) then one decode step == apply over S + 1 tokens."""
    _, cfg = _cfgs(arch)
    params = TM.mamba2_init(torch.Generator().manual_seed(1), cfg, "cpu")
    S = cfg.ssm_chunk + 3
    _, x = _x((1, S + 1, cfg.d_model), seed=12, scale=0.3, dtype="f32")
    _, cache = TM.mamba2_prefill(params, x[:, :S], cfg)
    y_dec, _ = TM.mamba2_decode(params, x[:, S : S + 1], cache, cfg)
    y_full = TM.mamba2_apply(params, x, cfg)
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_full[:, S]), atol=RECUR_TOL,
                               rtol=RECUR_TOL)


def _mixer_loss_grads(jp, tp, jcfg, tcfg, S, seed):
    """Loss ``sum(mamba2_apply(x) * r)`` and its grads w.r.t. every
    param, in both packages (f32 input x, so the products see f32
    activations against bf16 weights in both)."""
    jx, tx = _x((B, S, jcfg.d_model), seed=seed, dtype="f32")
    r = np.random.default_rng(seed + 1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda p: (JM.mamba2_apply(p, jx, jcfg).astype(jnp.float32) * r).sum())(jp)
    ps = map_tree(lambda t: t.detach().requires_grad_(True), tp)
    tl = (TM.mamba2_apply(ps, tx, tcfg).float() * torch.from_numpy(r)).sum()
    tg = torch.autograd.grad(tl, leaves(ps))
    return (jl, jax.tree.leaves(jg)), (tl, tg)


def test_mixer_grads_match_jax(mixer):
    jcfg, tcfg, jp, tp = mixer
    (jl, jg), (tl, tg) = _mixer_loss_grads(jp, tp, jcfg, tcfg, S=20, seed=13)
    assert abs(float(jl) - float(tl.detach())) <= 1e-2 * max(1.0, abs(float(jl)))
    _grads_close(list(tg), jg)


def test_decay_overflow_forward_matches_and_grads_stay_finite(mixer):
    """``dt_bias = 20``: dt ≈ 20 a token, so a chunk of 8 sums to ~160
    and exp(Λ_i − Λ_j) above the diagonal overflows f32. JAX's forward
    stays finite (it selects 0 there) and its grads are NaN (inf · 0 in
    the backward; ROADMAP §3); the port's forward equals JAX's, and its
    grads are finite and equal to JAX's at a chunk of 1 token, where no
    exponent is masked (the same function, its sums in another order)."""
    jcfg, tcfg, jp, tp = mixer
    jp = {**jp, "dt_bias": np.full_like(jp["dt_bias"], 20.0)}
    tp = {**tp, "dt_bias": torch.full_like(tp["dt_bias"], 20.0)}
    S = 20
    (jl, jg), (tl, tg) = _mixer_loss_grads(jp, tp, jcfg, tcfg, S=S, seed=14)
    jx, tx = _x((B, S, jcfg.d_model), seed=14, dtype="f32")
    jo, to = JM.mamba2_apply(jp, jx, jcfg), TM.mamba2_apply(tp, tx, tcfg)
    assert np.isfinite(_np(jo)).all() and np.isfinite(_np(to)).all()
    _close_to_scale(to, jo, OUT_REL)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)  # the reference's fault
    assert all(torch.isfinite(g).all() for g in tg)
    (_, jg1), _ = _mixer_loss_grads(jp, tp, dataclasses.replace(jcfg, ssm_chunk=1), tcfg,
                                    S=S, seed=14)
    # A_log's grad is dt·exp(-dt) ≈ 4e-8 a term here: what is left of it
    # is rounding noise (~1e-5, against 1e0–1e2 in the other leaves), so
    # it is held to 1e-6 of the largest grad instead
    top = max(float(np.abs(g).max()) for g in jg1)
    names = sorted(tp)  # leaves(tp) order; "norm" holds one leaf
    assert names[0] == "A_log"
    assert np.abs(tg[0].numpy() - np.asarray(jg1[0])).max() <= 1e-6 * top
    _grads_close(list(tg[1:]), jg1[1:])


@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_grads_match_jax(arch, compute, monkeypatch):
    """Training through the SSD by autograd: ``loss_fn`` of the whole
    smoke model (jamba: mamba, GQA and MoE layers, the MoE layers routed
    as JAX routed) and its grads against ``jax.value_and_grad``.

    ``compute="f32"`` sets both packages' ``COMPUTE_DTYPE`` to f32, so
    the two compute the same function with no bf16 rounding: grads
    within 1e-4 of each leaf's max, cosine >= 1 - 1e-6. In bf16 (as the
    models run) the loss agrees within 1e-3 and mamba2-2.7b's grads
    (2 layers) within the repo's bounds. jamba's 8 layers carry the two
    packages' bf16 rounding differences (XLA rounds a SwiGLU's
    silu(g)·u once, PyTorch twice: a layer's output moves by ~2 bf16
    ulps given the same input) through the backward; measured worst
    leaf 18% of its max, cosine 0.996, so its bf16 grads are held
    within 25% and cosine >= 0.99."""
    if compute == "f32":
        monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    jcfg, tcfg = _cfgs(arch)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    seen = record_jax_routing(monkeypatch)
    b = JD.MarkovSource(jcfg.vocab_size, 32, 4, seed=1).batch(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                             remat="none", loss_chunks=4), has_aux=True)(jp)
    jax.effects_barrier()
    n_moe = sum(s.ffn == "moe" for s in map(jcfg.layer_spec, range(jcfg.num_layers)))
    assert len(seen) == n_moe == (4 if arch == "jamba-v0.1-52b" else 0)
    with routing_as([torch.from_numpy(np.array(e, np.int64)) for _, e in seen]) as flips:
        tg, tm = make_grad_fn(tcfg, remat="none", loss_chunks=4)(
            tp, {k: torch.from_numpy(v) for k, v in b.items()})
    margins = flip_margins(seen, flips)
    assert all(m <= NEAR_TIE for m in margins), margins
    assert abs(float(jl) - float(tm["loss"])) < 1e-3
    if compute == "f32":
        bounds = (1e-4, 1 - 1e-6)
    else:
        bounds = (GRAD_REL, GRAD_COS) if arch == "mamba2-2.7b" else (0.25, 0.99)
    _grads_close(leaves(tg), jax.tree.leaves(jg), *bounds)
