"""The port's MoE (``repro_torch.models.moe``), its bf16 RMSNorm and the
deepseek-moe-16b model against the JAX package, on the smoke config
(d_model 64, 8 routed experts top-2 with d_ff 32, 2 shared experts).

Params come from the JAX initializers and inputs from numpy seeds; both
cross with ``params_from_numpy``. The expert-parallel path is held
against JAX's ``moe_apply_ep`` under ``shard_map`` on 8 virtual devices,
computed in one subprocess that writes its outputs to an ``.npz``.

Tolerances. Routing is f32 in both packages and picks the same experts
(asserted). The experts compute in bf16, rounded at other places by
XLA and PyTorch, so outputs agree within 2e-2 abs/rel (the JAX tests'
bound against ``moe_ref``) and the aux loss within 1e-5 relative (f32
sums in another order). The int8 wire is lossy: within 0.1 of the
reference's scale, as the JAX test bounds it. The model's logits agree
within 5% of their scale and its grads within 5% of each leaf's max
element with cosine >= 0.999 (``tests/test_torch_train.py``'s bounds).
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
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import chainwrite as cw  # noqa: E402
from repro_torch.core import program as prg  # noqa: E402
from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.launch.steps import make_grad_fn, make_train_step  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.parallel import hints  # noqa: E402
from repro_torch.parallel.collectives import sub_ring_orders  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from _jax_moe_routing import NEAR_TIE, flip_margins, record_jax_routing  # noqa: E402
from _moe_routing import routing_as  # noqa: E402

ARCH = "deepseek-moe-16b"
TOL = 2e-2
AUX_REL = 1e-5
LOGIT_REL = 5e-2
MAX_SEQ = 24
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _cfgs(**kw):
    return (dataclasses.replace(JC.get_smoke_config(ARCH), **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), **kw))


@pytest.fixture(scope="module")
def moe_params():
    jp = jax.device_get(JM.moe_init(jax.random.PRNGKey(0), JC.get_smoke_config(ARCH)))
    return jp, params_from_numpy(jp, "cpu")


def _x(shape, dtype, seed=1, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _aux_close(got, want):
    assert abs(float(got) - float(want)) <= AUX_REL * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("path", ["flat", "rowwise", "bf16_wire"])
def test_single_device_paths_match_jax(moe_params, path, dtype):
    """Flat, rowwise and ``moe_bf16_wire`` at ``capacity_factor=8`` (no
    drops): the same top-e experts, outputs and aux as JAX's, and both
    packages within the tolerance of their own ``moe_ref``."""
    jp, tp = moe_params
    kw = {"rowwise": dict(moe_row_dispatch=True), "bf16_wire": dict(moe_bf16_wire=True)}
    jcfg, tcfg = _cfgs(capacity_factor=8.0, **kw.get(path, {}))
    jx, tx = _x((3, 16, jcfg.d_model), dtype)
    jo, ja = JM.moe_apply(jp, jx, jcfg)
    to, ta = TM.moe_apply(tp, tx, tcfg)
    assert to.dtype == tx.dtype and tuple(to.shape) == jo.shape
    _, j_top = jax.lax.top_k(jax.nn.softmax(jx.reshape(-1, 64).astype(jnp.float32) @ jp["router"]),
                             jcfg.moe_top_k)
    _, _, t_top = TM._route(tx.reshape(-1, 64), tp["router"], tcfg.moe_top_k)
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    _close(to, jo)
    _aux_close(ta, ja)
    _close(to, TM.moe_ref(tp, tx, tcfg))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_moe_ref_matches_jax(moe_params, dtype):
    jp, tp = moe_params
    jcfg, tcfg = _cfgs()
    jx, tx = _x((2, 16, jcfg.d_model), dtype, seed=2)
    _close(TM.moe_ref(tp, tx, tcfg), JM.moe_ref(jp, jx, jcfg))


@pytest.mark.parametrize("path", ["flat", "rowwise"])
def test_tight_capacity_drops_what_jax_drops(moe_params, path):
    """``capacity_factor=0.05``: the dropped assignments equal JAX's and
    the outputs match. The dropped set is read from each package's own
    ``moe_apply``: with no shared experts and expert ``e``'s down
    projection writing only output column ``e``, ``out[t, e] != 0``
    exactly where token ``t``'s assignment to ``e`` was kept."""
    jp, tp = moe_params
    kw = dict(capacity_factor=0.05, moe_row_dispatch=path == "rowwise")
    jcfg, tcfg = _cfgs(**kw)
    jx, tx = _x((2, 64, jcfg.d_model), "f32")  # 16 assignments an expert, C = 8
    _close(TM.moe_apply(tp, tx, tcfg)[0], JM.moe_apply(jp, jx, jcfg)[0])
    assert not np.allclose(_np(TM.moe_apply(tp, tx, tcfg)[0]), _np(TM.moe_ref(tp, tx, tcfg)),
                           atol=1e-3)  # heavy drops: far from the oracle

    E = jcfg.num_experts
    wd = np.zeros_like(jp["wd"])
    for e in range(E):
        wd[e, :, e] = np.abs(np.random.default_rng(e).standard_normal(wd.shape[1])) + 0.5
    probe = {k: v for k, v in jp.items() if k != "shared"} | {"wd": wd}
    pcfg_j, pcfg_t = (dataclasses.replace(c, num_shared_experts=0) for c in (jcfg, tcfg))
    kept_j = _np(JM.moe_apply(probe, jx, pcfg_j)[0]).reshape(-1, 64)[:, :E] != 0
    kept_t = _np(TM.moe_apply(params_from_numpy(probe, "cpu"), tx, pcfg_t)[0]
                 ).reshape(-1, 64)[:, :E] != 0
    np.testing.assert_array_equal(kept_t, kept_j)
    _, _, top_e = TM._route(tx.reshape(-1, 64), tp["router"], tcfg.moe_top_k)
    routed = np.zeros_like(kept_t)
    np.put_along_axis(routed, top_e.numpy(), True, axis=1)
    assert kept_t.sum() < routed.sum() and not (kept_t & ~routed).any()


# ---------------------------------------------------------------------------
# Expert parallelism on the stacked view vs JAX's moe_apply_ep (shard_map)
# ---------------------------------------------------------------------------

EP_DEVICES = 8

_JAX_EP = """
import dataclasses
from repro import configs as C
from repro.models import moe as M

d = dict(np.load({path!r}))
cfg = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), capacity_factor=8.0)
params = {{k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}}
params["shared"] = {{k: jnp.asarray(d["shared_" + k]) for k in ("gate", "up", "down")}}
x = jnp.asarray(d["x"]).astype(jnp.bfloat16)
mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))

def ep(**kw):
    return jax.shard_map(lambda p, xs: M.moe_apply_ep(p, xs, cfg, "data", **kw), mesh=mesh,
                         in_specs=(P(), P("data")), out_specs=(P("data"), P()), check_vma=False)

out = {{}}
for name, kw in (("k1", {{}}), ("k2", {{"num_chains": 2}}), ("int8", {{"wire_dtype": "int8"}})):
    o, a = jax.jit(ep(**kw))(params, x)
    out[name], out[name + "_aux"] = np.asarray(o.astype(jnp.float32)), np.asarray(a)
with jax.set_mesh(mesh):
    o, a = jax.jit(lambda p, xs: M.moe_apply(p, xs, dataclasses.replace(
        cfg, moe_ep_dispatch=True)))(params, x)
out["auto"], out["auto_aux"] = np.asarray(o.astype(jnp.float32)), np.asarray(a)

def loss(p):
    o, a = ep()(p, x)
    return jnp.mean(o.astype(jnp.float32) ** 2) + a

for i, g in enumerate(jax.tree.leaves(jax.jit(jax.grad(loss))(params))):
    out[f"grad{{i}}"] = np.asarray(g)
np.savez({out!r}, **out)
print("jax ep done")
"""


@pytest.fixture(scope="module")
def ep_case(moe_params, run_multidevice, tmp_path_factory):
    """JAX's EP outputs (K = 1, K = 2, int8 direct, the auto route under
    ``jax.set_mesh``) and EP grads for one bf16 input, from one
    8-device subprocess, beside the port's params and input."""
    jp, tp = moe_params
    tmp = tmp_path_factory.mktemp("ep")
    x = (np.random.default_rng(3).standard_normal((EP_DEVICES, 4, 64)) * 0.5).astype(np.float32)
    flat = {k: jp[k] for k in ("router", "wg", "wu", "wd")}
    flat.update({"shared_" + k: v for k, v in jp["shared"].items()})
    np.savez(tmp / "in.npz", x=x, **flat)
    run_multidevice(_JAX_EP.format(path=str(tmp / "in.npz"), out=str(tmp / "out.npz")),
                    devices=EP_DEVICES, timeout=600)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    return dict(np.load(tmp / "out.npz")), tp, tx


def _ep(tp, tx, cfg, **kw):
    o, a = TM.moe_apply_ep(tp, tx.reshape(EP_DEVICES, 1, *tx.shape[1:]), cfg, **kw)
    return o.reshape(tx.shape), a


def test_ep_matches_jax_moe_apply_ep(ep_case):
    """K = 1 and K = 2 against JAX's shard_map EP, bit-identical to each
    other and within the tolerance of the flat path at capacity 8; the
    aux is the global one."""
    jout, tp, tx = ep_case
    _, tcfg = _cfgs(capacity_factor=8.0)
    o1, a1 = _ep(tp, tx, tcfg)
    o2, a2 = _ep(tp, tx, tcfg, num_chains=2)
    assert o1.dtype == torch.bfloat16 and torch.equal(o1, o2) and torch.equal(a1, a2)
    _close(o1, jout["k1"])
    _close(o2, jout["k2"])
    _aux_close(a1, jout["k1_aux"])
    fo, fa = TM.moe_apply(tp, tx.reshape(EP_DEVICES, 4, 64), tcfg)
    _close(o1, fo.reshape(tx.shape))
    _aux_close(a1, fa)


def test_ep_int8_wire_matches_jax_direct_path(ep_case):
    """int8 token payloads on both exchanges: held against JAX's direct
    ``moe_apply_ep(..., wire_dtype="int8")`` and against ``moe_ref``
    (0.1 of its scale); the expert ids travel exact, so the routing and
    the aux do not change."""
    jout, tp, tx = ep_case
    _, tcfg = _cfgs(capacity_factor=8.0)
    o8, a8 = _ep(tp, tx, tcfg, wire_dtype="int8")
    want = _np(TM.moe_ref(tp, tx.reshape(EP_DEVICES, 4, 64), tcfg)).reshape(tx.shape)
    scale = np.abs(want).max()
    assert np.abs(_np(o8) - want).max() / scale < 0.1
    assert np.abs(jout["int8"] - want).max() / scale < 0.1
    _close(o8, jout["int8"])
    _aux_close(a8, jout["int8_aux"])
    assert not torch.equal(o8, _ep(tp, tx, tcfg)[0])  # the wire really quantized


def test_ep_auto_route(ep_case):
    """``moe_ep_dispatch`` under ``hints.set_mesh`` with 8 DP ranks runs
    EP (equal to the direct call, as JAX's auto route equals its direct
    one); without a mesh, or with a group that does not divide the
    batch or the experts, it takes the flat path."""
    jout, tp, tx = ep_case
    _, tcfg = _cfgs(capacity_factor=8.0, moe_ep_dispatch=True)
    x = tx.reshape(EP_DEVICES, 4, 64)
    with hints.set_mesh(make_host_mesh(data=EP_DEVICES)):
        auto, aux = TM.moe_apply(tp, x, tcfg)
    assert torch.equal(auto, _ep(tp, tx, tcfg)[0].reshape(x.shape))
    _close(auto, jout["auto"].reshape(x.shape))
    _aux_close(aux, jout["auto_aux"])
    assert hints.concrete_mesh() is None
    with pytest.raises(ValueError, match="per-row MoE params"):  # one tree per rank, no group
        TM.moe_apply([tp] * EP_DEVICES, x, tcfg)
    flat = TM._moe_apply_flat(tp, x, tcfg)[0]
    assert torch.equal(TM.moe_apply(tp, x, tcfg)[0], flat)
    for mesh in (make_host_mesh(data=3), make_mesh((1,), ("model",))):  # 3 divides neither
        with hints.set_mesh(mesh):
            assert torch.equal(TM.moe_apply(tp, x, tcfg)[0], flat)
    with hints.set_mesh(make_host_mesh(data=4)):
        cfg_k2 = dataclasses.replace(tcfg, moe_ep_chains=2, moe_ep_int8_wire=True)
        want = TM.moe_apply_ep(tp, x.reshape(4, 2, 4, 64), tcfg, num_chains=2, wire_dtype="int8")
        assert torch.equal(TM.moe_apply(tp, x, cfg_k2)[0], want[0].reshape(x.shape))


def test_ep_grads_flow_and_match(ep_case):
    """Gradients flow through the three exchanges: finite, equal to
    JAX's through its shard_map EP, and to the port's flat path's at
    capacity 8 (no drops), within 2e-2 of each leaf's max."""
    jout, tp, tx = ep_case
    _, tcfg = _cfgs(capacity_factor=8.0)

    def grads(fn):
        ps = {k: (v.detach().requires_grad_(True) if isinstance(v, torch.Tensor)
                  else {kk: vv.detach().requires_grad_(True) for kk, vv in v.items()})
              for k, v in tp.items()}
        o, a = fn(ps)
        return torch.autograd.grad((o.float() ** 2).mean() + a, leaves(ps))

    g_ep = grads(lambda ps: _ep(ps, tx, tcfg))
    g_flat = grads(lambda ps: TM.moe_apply(ps, tx.reshape(EP_DEVICES, 4, 64), tcfg))
    for i, (ge, gf) in enumerate(zip(g_ep, g_flat)):
        assert torch.isfinite(ge).all()
        want = jout[f"grad{i}"]
        assert ge.shape == want.shape
        span = np.abs(want).max()
        assert np.abs(_np(ge) - want).max() <= TOL * span, i
        assert np.abs(_np(ge) - _np(gf)).max() <= TOL * span, i


@pytest.mark.parametrize("wire", [None, "int8"])
def test_ep_wire_bytes_are_the_three_programs(moe_params, wire):
    """The executor's byte count of one EP call is ``program_wire_bytes``
    of its three all-to-alls: the token payload out and back (int8: one
    byte an element plus a 4-byte scale per frame, 4x fewer than the
    payload at f32) and the int32 expert ids, always exact."""
    jp, tp = moe_params
    _, tcfg = _cfgs(capacity_factor=8.0)
    n, T = EP_DEVICES, 4
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 1, T, 64))
                         .astype(np.float32)).to(torch.bfloat16)
    cw.wire_counter.reset()
    TM.moe_apply_ep(tp, x, tcfg, num_chains=2, wire_dtype=wire)
    C_pair = TM._bucket_capacity(T * tcfg.moe_top_k, n, 8.0)
    prog = prg.plan_all_to_all(n, tuple(sub_ring_orders(n, 2)), wire_dtype=wire)
    ids = prg.plan_all_to_all(n, tuple(sub_ring_orders(n, 2)))
    tok = n * C_pair * 64 * (4 if wire else 2)  # per-device bytes the executor prices
    want = 2 * prg.program_wire_bytes(prog, tok) + prg.program_wire_bytes(ids, n * C_pair * 4)
    assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes() == want
    if wire:
        frames = sum(s.num_permutes() for s in prog.steps)
        payload = 2 * prg.program_wire_bytes(prog.with_wire_dtype(None), tok)
        assert 2 * prg.program_wire_bytes(prog, tok) == payload // 4 + 2 * 4 * frames


# ---------------------------------------------------------------------------
# bf16 RMSNorm and the deepseek-moe-16b model
# ---------------------------------------------------------------------------


def test_bf16_rmsnorm_forward_and_vjp_match_jax():
    """``RMSNormBF16`` against JAX's ``_rmsnorm_bf16`` custom VJP: the
    forward and both cotangents, all (B,S,d) tensors in bf16."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jx, jg = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    jy, vjp = jax.vjp(lambda s, xx: JL.rmsnorm({"scale": s}, xx, 1e-5, bf16=True),
                      jnp.asarray(scale), jx)
    jds, jdx = vjp(jg)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    ty = TL.rmsnorm({"scale": ts}, tx, 1e-5, bf16=True)
    tds, tdx = torch.autograd.grad(ty, (ts, tx), torch.from_numpy(g).to(torch.bfloat16))
    assert ty.dtype == tdx.dtype == torch.bfloat16 and tds.dtype == torch.float32
    bf16 = 2 ** -7  # one bf16 ulp, relative
    np.testing.assert_allclose(_np(ty), _np(jy), atol=bf16, rtol=bf16)
    np.testing.assert_allclose(_np(tdx), _np(jdx), atol=2 * bf16, rtol=2 * bf16)
    np.testing.assert_allclose(_np(tds), _np(jds), atol=1e-4, rtol=1e-4)
    f32 = TL.rmsnorm({"scale": ts}, tx.float(), 1e-5)  # the f32-variance path
    np.testing.assert_allclose(_np(ty), _np(f32), atol=4 * bf16, rtol=4 * bf16)


def test_bf16_rmsnorm_row_blocks_match_one_block(monkeypatch):
    """The bf16 norm's f32 rowwise sums run over blocks of rows: with
    blocks of 3 rows (the last one short) the forward and ``dx`` equal
    the one-block result bit for bit (each row's sum is the same), and
    ``dscale`` agrees within f32 reordering."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(np.float32))

    def run():
        ts, tx = scale.clone().requires_grad_(True), x.clone().requires_grad_(True)
        y = TL.rmsnorm({"scale": ts}, tx, 1e-5, bf16=True)
        return (y, *torch.autograd.grad(y, (ts, tx), g))

    y1, ds1, dx1 = run()
    monkeypatch.setattr(TL, "_F32_BLOCK", 3 * 64)
    assert len(list(TL._row_blocks(16, 64))) == 6
    y2, ds2, dx2 = run()
    assert torch.equal(y1, y2) and torch.equal(dx1, dx2)
    np.testing.assert_allclose(ds2.numpy(), ds1.numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def model():
    jcfg = JC.get_smoke_config(ARCH)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _logits_close(got, want):
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= LOGIT_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("bf16_norm", [False, True])
def test_model_prefill_and_decode_match_jax(model, bf16_norm, monkeypatch):
    """deepseek-moe-16b smoke (layer 0 dense, layers 1-2 MoE, default
    capacity): prefill logits, then three decode steps (MoE on (B, 1,
    d)) with per-slot positions."""
    jp, tp = model
    jcfg, tcfg = _cfgs(bf16_norm=bf16_norm)
    seen = record_jax_routing(monkeypatch)
    S = 12
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    pos, cur = np.array([S, S - 3], np.int32), toks[:, -1]
    jlogits, feeds = [], []
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    jlogits.append(jl)
    for step in range(3):
        feeds.append(cur)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(cur), jnp.asarray(pos + step), jc)
        jlogits.append(jl)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jax.effects_barrier()
    assert len(seen) == 4 * 2  # 2 MoE layers, prefill + 3 steps

    with routing_as([torch.from_numpy(np.array(e, np.int64)) for _, e in seen]) as flips:
        tl, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
        _logits_close(tl, jlogits[0])
        for step, cur in enumerate(feeds):
            tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(cur.copy()),
                                    torch.from_numpy(pos + step), tc)
            _logits_close(tl, jlogits[step + 1])
    margins = flip_margins(seen, flips)
    assert all(m <= NEAR_TIE for m in margins), margins


@pytest.mark.parametrize("bf16_norm", [False, True])
def test_model_loss_aux_and_grads_match_jax(model, bf16_norm, monkeypatch):
    """``loss_fn`` with the MoE aux folded in, and its grads, against
    ``jax.value_and_grad`` — through the bf16 norm's custom backward
    when it is on."""
    jp, tp = model
    jcfg, tcfg = _cfgs(bf16_norm=bf16_norm)
    seen = record_jax_routing(monkeypatch)
    b = JD.MarkovSource(jcfg.vocab_size, 32, 4, seed=1).batch(0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                             remat="none", loss_chunks=4), has_aux=True)(jp)
    jax.effects_barrier()
    assert len(seen) == 2
    with routing_as([torch.from_numpy(np.array(e, np.int64)) for _, e in seen]) as flips:
        tg, tm = make_grad_fn(tcfg, remat="none", loss_chunks=4)(
            tp, {k: torch.from_numpy(v) for k, v in b.items()})
    margins = flip_margins(seen, flips)
    assert all(m <= NEAR_TIE for m in margins), margins
    assert float(tm["aux"]) > 0
    assert abs(float(jm["aux"]) - float(tm["aux"])) <= 1e-3 * float(jm["aux"])
    assert abs(float(jl) - float(tm["loss"])) < 1e-3
    for a, g in zip(jax.tree.leaves(jg), leaves(tg)):
        a, g = np.asarray(a, np.float64), g.double().numpy()
        assert a.shape == g.shape and np.isfinite(g).all()
        assert np.abs(a - g).max() <= 5e-2 * np.abs(a).max()
        assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= 0.999


def test_stacked_xla_step_takes_the_global_capacity_like_jax(model, monkeypatch):
    """The stacked view's ``collectives="xla"`` step at DP = 2 on a
    capacity that drops assignments (``capacity_factor=0.5``: 16 slots an
    expert for the batch's 256 assignments) against JAX's xla step: the
    loss, the aux loss, the grad norm and every grad. JAX's xla step is
    GSPMD's function of the whole batch — ``value_and_grad(loss_fn)``
    (``repro.launch.steps:178-193``), whatever the mesh's size — so its
    capacity, positions and aux loss are the global batch's, and so are
    the port's. Routing is pinned to JAX's; the tolerances are
    :func:`test_model_loss_aux_and_grads_match_jax`'s. Each rank's own
    capacity would give another aux loss (asserted, so the case tells
    the two apart)."""
    from repro.launch import steps as JS
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.optim import adamw as JA
    from repro_torch.launch import steps as TS

    jp, _ = model
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    b = JD.MarkovSource(jcfg.vocab_size, 32, 4, seed=1).batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    seen = record_jax_routing(monkeypatch)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb, remat="none", loss_chunks=4), has_aux=True)(jp)
    jax.effects_barrier()
    assert len(seen) == 2
    experts = [torch.from_numpy(np.array(e, np.int64)) for _, e in seen]
    load = torch.bincount(experts[0].reshape(-1), minlength=jcfg.num_experts)
    assert int(load.max()) > TM.capacity(tcfg, 4 * 32)  # assignments are dropped
    opt = dict(peak_lr=1e-2, warmup_steps=1)
    with jax.set_mesh(jax_host_mesh(model=1)):
        step = JS.make_train_step(jcfg, JA.OptConfig(**opt), remat="none", collectives="xla",
                                  loss_chunks=4)
        _, _, jsm = jax.jit(step)(jp, JA.init(jp), jb)
    jax.effects_barrier()
    seen = seen[:2]  # the step's own routing calls follow
    assert abs(float(jsm["loss"]) - float(jl)) < 1e-3  # jit and eager round apart
    got = []
    update = TS.adamw.update
    monkeypatch.setattr(TS.adamw, "update", lambda c, g, *a, **k: got.append(g) or update(
        c, g, *a, **k))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    p = params_from_numpy(jax.device_get(jp), "cpu")
    with routing_as(experts) as flips:
        _, _, tm = TS.make_train_step(tcfg, TA.OptConfig(**opt), remat="none", collectives="xla",
                                      mesh=make_host_mesh(data=2), loss_chunks=4)(
            p, TA.init(p), tb)
    margins = flip_margins(seen, flips)
    assert all(m <= NEAR_TIE for m in margins), margins
    assert abs(float(jsm["aux"]) - float(tm["aux"])) <= 1e-3 * float(jsm["aux"])
    assert abs(float(jsm["loss"]) - float(tm["loss"])) < 1e-3
    assert abs(float(jsm["grad_norm"]) - float(tm["grad_norm"])) <= 1e-2 * float(
        jsm["grad_norm"])
    (tg,) = got
    for a, g in zip(jax.tree.leaves(jg), leaves(tg)):
        a, g = np.asarray(a, np.float64), g.double().numpy()
        assert a.shape == g.shape and np.isfinite(g).all()
        assert np.abs(a - g).max() <= 5e-2 * np.abs(a).max()
        assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= 0.999
    # each rank's own capacity and aux loss: what the step no longer takes
    halves = [{k: v[r * 2:(r + 1) * 2] for k, v in tb.items()} for r in range(2)]
    with routing_as([e.reshape(2, -1, e.shape[-1])[r] for r in range(2) for e in experts]):
        own = [make_grad_fn(tcfg, remat="none", loss_chunks=4)(p, h)[1]["aux"] for h in halves]
    assert abs(float(sum(own)) / 2 - float(jm["aux"])) > 1e-2 * float(jm["aux"])


def test_ep_training_with_dp_raises(model, monkeypatch, tmp_path):
    """EP inside the train step: with DP 4, ``make_train_step`` (torrent
    and xla) and the ``Trainer`` run the ranks in one forward whose MoE
    layers exchange tokens (``tests/test_torch_ep_train.py`` holds them
    against JAX); nothing raises. With one rank there is no exchange: the
    step is the per-rank step, and its MoE layers take the flat path; so
    do they when the ranks do not divide the experts."""
    jp, _ = model
    _, tcfg = _cfgs(moe_ep_dispatch=True)
    opt = TA.OptConfig()
    b = {k: torch.from_numpy(v) for k, v in
         JD.MarkovSource(tcfg.vocab_size, 16, 8, seed=1).batch(0).items()}
    calls = []
    ep = TM.moe_apply_ep
    monkeypatch.setattr(TM, "moe_apply_ep", lambda *a, **k: calls.append(tuple(a[1].shape))
                        or ep(*a, **k))
    for collectives in ("torrent", "xla"):
        p = params_from_numpy(jax.device_get(jp), "cpu")
        step = make_train_step(tcfg, opt, collectives=collectives, mesh=make_host_mesh(data=4),
                               loss_chunks=2)
        _, _, m = step(p, TA.init(p), b)
        assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    # 2 MoE layers, each run again by the remat'd backward, x 2 steps; all
    # on the stacked view
    assert calls == [(4, 2, 16, 64)] * 8
    # no shipped config sets moe_ep_dispatch: the Trainer is handed one
    out = TTrain.Trainer(TTrain.TrainConfig(arch=ARCH, dp=4, collectives="torrent", steps=1,
                                            global_batch=8, seq_len=16, loss_chunks=2,
                                            ckpt_dir=str(tmp_path)),
                         device="cpu", model_cfg=tcfg).run()
    assert out["final_step"] == 1 and np.isfinite(out["losses"]).all() and len(calls) == 12
    calls.clear()
    p = params_from_numpy(jax.device_get(jp), "cpu")
    make_train_step(tcfg, opt, mesh=make_host_mesh(data=1))(p, TA.init(p), b)  # one rank
    # 3 ranks do not divide the 8 experts: each rank's MoE layers take the
    # flat path on its own tokens, as JAX's manual-axis route falls back
    b6 = {k: v[:6] for k, v in b.items()}
    make_train_step(tcfg, opt, collectives="torrent", mesh=make_host_mesh(data=3))(
        p, TA.init(p), b6)
    assert calls == []
