"""The port's training path against the JAX package: the chunked loss
and its grads, AdamW, the data sources, checkpoints (each package
restores the other's), the resilient loop, and whole Trainer runs
(the int8 + EF run across a restart is
``tests/test_torch_train_restart.py``'s, split so that a parallel run
can spread the two files).

Tolerances. The models compute in bf16, and PyTorch rounds after every
op where XLA keeps f32 between fused ops, so the loss agrees within
1e-3 and each grad leaf within 5% of its largest element (measured:
<= 1.8%), cosine >= 0.999. Trainer loss trajectories from identical params agree within 5e-3
per step (measured <= 5e-4 over 8 steps). AdamW and the optimizer
state: 1e-5 relative (atol 1e-8), since the global norm sums the leaves
in another order and a clipped step carries that last-bit difference
into every update. Data, checkpoints and the loop's replay are exact.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import make_grad_fn, make_train_step  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.parallel.collectives import ef_residual_init  # noqa: E402
from repro_torch.runtime import failure as TF  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

ARCH = "yi-6b"


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(JT.model_init(jax.random.PRNGKey(0), JC.get_smoke_config(ARCH)))


def _batch(B=4, S=32, step=0):
    return JD.MarkovSource(JC.get_smoke_config(ARCH).vocab_size, S, B, seed=1).batch(step)


@pytest.mark.parametrize("loss_chunks", [4, 3])
@pytest.mark.parametrize("remat", ["dots", "none"])
def test_loss_and_grads_match_jax(jax_params, loss_chunks, remat):
    """``loss_fn`` (chunked CE + z-loss; 3 chunks do not divide S = 32
    and drop to 2) and its autograd grads against jax.value_and_grad."""
    cfg = JC.get_smoke_config(ARCH)
    b = _batch()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, cfg, {k: jnp.asarray(v) for k, v in b.items()},
                             remat=remat, loss_chunks=loss_chunks), has_aux=True)(jax_params)
    tp = params_from_numpy(jax_params, "cpu")
    tg, tm = make_grad_fn(TCfg.get_smoke_config(ARCH), remat=remat,
                          loss_chunks=loss_chunks)(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(jl) - float(tm["loss"])) < 1e-3
    assert abs(float(jm["ce"]) - float(tm["ce"])) < 1e-3 and float(tm["aux"]) == 0.0
    for a, g in zip(jax.tree.leaves(jg), leaves(tg)):
        a, g = np.asarray(a, np.float64), g.double().numpy()
        assert a.shape == g.shape
        assert np.abs(a - g).max() <= 5e-2 * np.abs(a).max()
        assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= 0.999


def test_remat_and_attention_impls_agree(jax_params):
    """remat changes memory, not numbers (bitwise on the CPU); the
    chunked attention twin trains like the reference one."""
    cfg = TCfg.get_smoke_config(ARCH)
    tp = params_from_numpy(jax_params, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    g_dots, m_dots = make_grad_fn(cfg, remat="dots")(tp, b)
    g_none, m_none = make_grad_fn(cfg, remat="none")(tp, b)
    assert torch.equal(m_dots["loss"], m_none["loss"])
    assert all(torch.equal(x, y) for x, y in zip(leaves(g_dots), leaves(g_none)))
    chunked = dataclasses.replace(cfg, attn_impl="chunked", attn_chunk=8)
    g_ch, m_ch = make_grad_fn(chunked)(tp, b)
    assert abs(float(m_ch["loss"]) - float(m_dots["loss"])) < 1e-3
    with pytest.raises(ValueError, match="remat"):
        make_grad_fn(cfg, remat="everything")(tp, b)


def test_flash_attention_under_autograd_raises(jax_params):
    """The flash kernel has no backward (JAX cannot differentiate the
    Pallas kernel either): training with attn_impl="flash" raises, on
    the CPU as on the card; without grads the same forward runs."""
    cfg = dataclasses.replace(TCfg.get_smoke_config(ARCH), attn_impl="flash")
    tp = params_from_numpy(jax_params, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(RuntimeError, match="no backward"):
        make_grad_fn(cfg)(tp, b)
    with torch.no_grad():
        loss, _ = TT.loss_fn(tp, cfg, b)
    ref_loss, _ = TT.loss_fn(tp, dataclasses.replace(cfg, attn_impl="reference"), b)
    assert abs(float(loss) - float(ref_loss)) < 1e-3


def test_kernel_wrappers_refuse_autograd_on_cpu():
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.relayout import ops as R

    q = torch.randn((1, 2, 16, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, q, q)
    with torch.no_grad():
        assert FA.flash_attention(q, q, q).grad_fn is None
    FA.flash_attention(q.detach(), q.detach(), q.detach())
    x = R.dense_to_blocked(torch.randn((16, 16)), (8, 8)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        R.relayout(x, (16, 16), (8, 8), (16, 16))
    with torch.inference_mode():
        R.relayout(x, (16, 16), (8, 8), (16, 16))


def _rand_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": [(rng.standard_normal((3,)) * scale).astype(np.float32),
                  (rng.standard_normal((2, 2, 4)) * scale).astype(np.float32)]}


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 50.0])
def test_adamw_update_matches_jax(grad_scale):
    """Five AdamW steps (warmup, clipping at the larger grad scales,
    decay) from carried state: params, moments, lr and grad norm within
    f32 rounding, written into the buffers of the params and state."""
    rng = np.random.default_rng(int(grad_scale * 10))
    cfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=6)
    jc, tc = JA.OptConfig(**cfg), TA.OptConfig(**cfg)
    p = _rand_tree(rng)
    jp, js = jax.tree.map(jnp.asarray, p), JA.init(jax.tree.map(jnp.asarray, p))
    tp = params_from_numpy(p, "cpu")
    ts = params_from_numpy(jax.device_get(js), "cpu")
    for _ in range(5):
        g = _rand_tree(rng, grad_scale)
        jp, js, jm = JA.update(jc, jax.tree.map(jnp.asarray, g), js, jp)
        buffers = leaves((tp, ts))
        tp, ts, tm = TA.update(tc, params_from_numpy(g, "cpu"), ts, tp)
        assert all(a is b for a, b in zip(buffers, leaves((tp, ts))))
        for a, b in zip(jax.tree.leaves((jp, js["mu"], js["nu"])),
                        leaves((tp, ts["mu"], ts["nu"]))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-8)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_sources_give_jax_batches(step):
    for J, T in ((JD.MarkovSource(256, 33, 6, seed=3), TD.MarkovSource(256, 33, 6, seed=3)),
                 (JD.UniformSource(1000, 17, 4, seed=5), TD.UniformSource(1000, 17, 4, seed=5))):
        jb, tb = J.batch(step), T.batch(step, host_slice=slice(None))
        assert jb.keys() == tb.keys()
        assert all(np.array_equal(jb[k], tb[k]) for k in jb)
        sl = slice(2, 4)
        assert np.array_equal(J.batch(step, host_slice=sl)["tokens"],
                              T.batch(step, host_slice=sl)["tokens"])


def test_prefetcher_and_placer():
    src = TD.MarkovSource(64, 8, 2, seed=0)
    pf = TD.Prefetcher(src, start_step=3, place=TD.make_device_placer("cpu"))
    try:
        for want in (3, 4, 5):
            step, batch = next(pf)
            assert step == want and isinstance(batch["tokens"], torch.Tensor)
            assert np.array_equal(batch["tokens"].numpy(), src.batch(want)["tokens"])
    finally:
        pf.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.make_device_placer()


def _state(params, opt, ef=None):
    s = {"params": params, "opt": opt}
    if ef is not None:
        s["ef"] = ef
    return s


def test_checkpoints_cross_restore(tmp_path, jax_params):
    """A JAX checkpoint restores in the port and a port checkpoint in
    JAX, with the same manifest keys and files, values bit for bit."""
    jp = jax.tree.map(jnp.asarray, jax_params)
    jopt = JA.init(jp)
    jopt = {**jopt, "step": jnp.asarray(7, jnp.int32),
            "mu": jax.tree.map(lambda x: x + 1.0, jopt["mu"])}
    jef = jax.tree.map(lambda p: jnp.full((4,) + p.shape, 0.5, jnp.float32), jp)
    jstate = _state(jp, jopt, jef)
    jm = JCkpt(str(tmp_path / "jax"))
    jm.save(3, jstate, blocking=True)
    jm.close()

    cfg = TCfg.get_smoke_config(ARCH)
    like_p = TT.model_init(torch.Generator().manual_seed(1), cfg, "cpu")
    like = _state(like_p, TA.init(like_p), ef_residual_init(like_p, 4))
    tm = CheckpointManager(str(tmp_path / "jax"))
    assert tm.all_steps() == [3]
    got = tm.restore(3, like, device="cpu")
    tm.close()
    for a, b in zip(jax.tree.leaves(jax.device_get(jstate)), leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy()) and b.dtype != torch.float64
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 7

    tm = CheckpointManager(str(tmp_path / "port"), keep_last_k=2)
    for s in (1, 2, 5):
        tm.save(s, got)
    tm.close()
    assert tm.all_steps() == [2, 5]
    jm = JCkpt(str(tmp_path / "port"))
    back = jm.restore(5, jstate)
    jm.close()
    for a, b in zip(jax.tree.leaves(back), leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy())
    man = [json.loads((tmp_path / d / "ckpt_000000005" if d == "port" else
                       tmp_path / d / "ckpt_000000003").joinpath("manifest.json").read_text())
           for d in ("jax", "port")]
    assert man[0]["leaves"] == man[1]["leaves"]
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(str(tmp_path / "port")).restore(
            5, _state(map_tree(lambda t: t[..., :1], like_p), like["opt"], like["ef"]),
            device="cpu")


def test_resilient_loop_restarts_and_replays_exactly(tmp_path):
    """A failure at step 5 rolls back to the step-3 checkpoint and
    replays: the final state equals the uninterrupted run's bit for bit,
    and the injected node failure can instead be re-formed around."""
    def run(fail_at, reform=None, node=None):
        state = {"w": torch.zeros(4), "n": torch.zeros((), dtype=torch.int32)}
        inj = TF.FaultInjector(fail_at, node=node)

        def step_fn(s, i):
            inj.maybe_fail(i)
            return {"w": s["w"] * 0.5 + torch.arange(4.0) * (i + 1), "n": s["n"] + 1}, {"i": i}

        ckpt = CheckpointManager(str(tmp_path / f"l{fail_at}{node}"), keep_last_k=5)
        out, res = TF.resilient_loop(state=state, step_fn=step_fn, num_steps=9, ckpt=ckpt,
                                     ckpt_every=3, reform_fn=reform)
        ckpt.close()
        return out, res

    clean, r0 = run(())
    failed, r1 = run((5,))
    assert (r0.restarts, r1.restarts, r1.final_step) == (0, 1, 9)
    assert torch.equal(clean["w"], failed["w"]) and int(failed["n"]) == 9
    assert [m["i"] for m in r1.metrics_history] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 8]
    reformed, r2 = run((5,), reform=lambda nodes: True, node=2)
    assert (r2.restarts, r2.reforms) == (0, 1) and torch.equal(reformed["w"], clean["w"])


_JAX_TRAINER = """
import json
from repro.launch.train import TrainConfig, Trainer
base = dict(arch='yi-6b', smoke=True, steps={steps}, global_batch=8, seq_len=32,
            peak_lr=2e-3, warmup_steps=3, ckpt_every=100, loss_chunks=2,
            log_every=100, collectives='torrent')
out = {{}}
for name, kw in (('exact', {{}}), ('int8', {{'compress_grads': True}})):
    out[name] = Trainer(TrainConfig(ckpt_dir={root!r} + '/' + name, **base, **kw)).run()['losses']
print('LOSSES', json.dumps(out))
"""


def test_trainer_matches_jax_trainer(run_multidevice, tmp_path):
    """JAX's Trainer (torrent, 4 virtual devices) and the port's
    (``dp=4`` on the CPU), both wires, from the same params (the port
    restores JAX's step-0 checkpoint): loss trajectories agree within
    5e-3 per step."""
    steps = 6
    out = run_multidevice(_JAX_TRAINER.format(steps=steps, root=str(tmp_path)), devices=4)
    jl = json.loads(out.split("LOSSES", 1)[1])
    cfg = TCfg.get_smoke_config(ARCH)
    like_p = TT.model_init(torch.Generator().manual_seed(1), cfg, "cpu")
    for name, compress in (("exact", False), ("int8", True)):
        like = _state(like_p, TA.init(like_p),
                      ef_residual_init(like_p, 4) if compress else None)
        start = CheckpointManager(str(tmp_path / name)).restore(0, like, device="cpu")
        tc = TTrain.TrainConfig(arch=ARCH, smoke=True, steps=steps, global_batch=8,
                                seq_len=32, peak_lr=2e-3, warmup_steps=3, ckpt_every=100,
                                loss_chunks=2, log_every=100, collectives="torrent", dp=4,
                                compress_grads=compress,
                                ckpt_dir=str(tmp_path / f"port_{name}"))
        trainer = TTrain.Trainer(tc, device="cpu", params=start["params"])
        if compress:
            assert all(float(r.abs().max()) == 0 for r in leaves(start["ef"]))
        got = trainer.run()["losses"]
        assert len(got) == steps == len(jl[name])
        assert max(abs(a - b) for a, b in zip(got, jl[name])) < 5e-3, (got, jl[name])


def test_train_step_knob_validation_matches_jax():
    from repro.launch.steps import make_train_step as jmake

    cfg_j, cfg_t = JC.get_smoke_config(ARCH), TCfg.get_smoke_config(ARCH)
    for kw in ({"compress_grads": True}, {"error_feedback": True},
               {"collectives": "torrent", "compress_grads": True, "error_feedback": True,
                "microbatches": 2},
               {"bucket_bytes": 1024}, {"topology": "pods=2"}):
        with pytest.raises(ValueError):
            jmake(cfg_j, JA.OptConfig(), **kw)
        with pytest.raises(ValueError):
            make_train_step(cfg_t, TA.OptConfig(), **kw)


@pytest.mark.parametrize("collectives,microbatches", [("xla", 1), ("xla", 2), ("torrent", 2)])
def test_xla_and_microbatched_steps_agree_with_torrent(jax_params, collectives, microbatches):
    """The plain-mean backend and gradient accumulation give the torrent
    single-pass step's update: the plain mean within f32 rounding of the
    sums; microbatches within the bf16 noise of matmuls of other shapes
    (grads within 1e-4: atol 1e-6 on a step of lr 1e-2). A large eps
    keeps AdamW's first step linear in the grads instead of their sign,
    which rounding could flip for a near-zero grad."""
    cfg = TCfg.get_smoke_config(ARCH)
    b = {k: torch.from_numpy(v) for k, v in _batch(B=8).items()}
    mesh = make_host_mesh(data=2)
    outs = []
    for kw in ({"collectives": "torrent"},
               {"collectives": collectives, "microbatches": microbatches}):
        p = params_from_numpy(jax_params, "cpu")
        step = make_train_step(cfg, TA.OptConfig(peak_lr=1e-2, warmup_steps=1, eps=1.0),
                               mesh=mesh, loss_chunks=2, **kw)
        new_p, _, m = step(p, TA.init(p), b)
        outs.append((new_p, m))
    (p0, m0), (p1, m1) = outs
    assert abs(float(m0["loss"]) - float(m1["loss"])) < 1e-4
    assert abs(float(m0["grad_norm"]) / float(m1["grad_norm"]) - 1) < 1e-3
    for a, c in zip(leaves(p0), leaves(p1)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_xla_step_matches_jax(jax_params, microbatches):
    """The plain-mean step (2 virtual ranks) with and without gradient
    accumulation against JAX's ``collectives="xla"`` step on the same
    params and batch: loss within 1e-3, grad norm within 1e-2
    relative, and each leaf's update within 5% of its largest element,
    cosine >= 0.999 (the grads' tolerance, carried through a first
    AdamW step that a large eps keeps linear in the grads; measured:
    loss 3e-5, grad norm 8e-4, updates 1.4%, cosine 0.99991)."""
    from repro.launch.steps import make_train_step as jmake

    cfg_j, cfg_t = JC.get_smoke_config(ARCH), TCfg.get_smoke_config(ARCH)
    kw = dict(peak_lr=1e-2, warmup_steps=1, eps=1.0)
    b = _batch(B=8)
    jp = jax.tree.map(jnp.asarray, jax_params)
    new_jp, _, jm = jmake(cfg_j, JA.OptConfig(**kw), collectives="xla", loss_chunks=2,
                          microbatches=microbatches)(
        jp, JA.init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    tp = params_from_numpy(jax_params, "cpu")
    step = make_train_step(cfg_t, TA.OptConfig(**kw), collectives="xla",
                           mesh=make_host_mesh(data=2), loss_chunks=2,
                           microbatches=microbatches)
    new_tp, _, tm = step(tp, TA.init(tp), {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(jm["loss"]) - float(tm["loss"])) < 1e-3
    assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < 1e-2
    for p0, a, c in zip(jax.tree.leaves(jax_params), jax.tree.leaves(new_jp), leaves(new_tp)):
        da = np.asarray(a, np.float64) - np.asarray(p0, np.float64)
        dc = c.double().numpy() - np.asarray(p0, np.float64)
        assert np.abs(da - dc).max() <= 5e-2 * np.abs(da).max()
        assert (da * dc).sum() / np.sqrt((da * da).sum() * (dc * dc).sum()) >= 0.999


def test_train_cli_runs_on_cpu(tmp_path):
    out = TTrain.main(["--device", "cpu", "--smoke", "--steps", "2", "--batch", "4",
                       "--seq", "16", "--dp", "2", "--collectives", "torrent",
                       "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 2 and np.isfinite(out["losses"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTrain.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path / "x")])


@pytest.mark.parametrize("n,tp", [(8, 1), (8, 2), (6, 4), (7, 4), (3, 8), (16, 16), (12, 8)])
def test_elastic_mesh_matches_jax(n, tp):
    from repro.runtime.elastic import choose_mesh_shape as jchoose

    from repro_torch.runtime import elastic as TE

    assert TE.choose_mesh_shape(n, tp) == jchoose(n, tp)
    data, model = TE.choose_mesh_shape(n, tp)
    if model == 1:
        mesh = TE.make_elastic_mesh(n, tp)
        assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": data, "model": 1}
    else:
        with pytest.raises(NotImplementedError, match="ProcessMesh"):
            TE.make_elastic_mesh(n, tp)


def test_reshard_state_is_a_device_move():
    from repro_torch.runtime.elastic import reshard_state

    state = {"params": {"w": torch.ones(3)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    moved = reshard_state(state, "cpu")
    assert torch.equal(moved["params"]["w"], state["params"]["w"])
    assert moved["opt"]["step"].dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reshard_state(state)


def test_train_step_records_spans(jax_params):
    """``spans`` sees one fwd_bwd per rank, one reduce and one optimizer
    span per step (the host clock on the CPU)."""
    from repro_torch.runtime.spans import Spans

    spans = Spans()
    p = params_from_numpy(jax_params, "cpu")
    step = make_train_step(TCfg.get_smoke_config(ARCH), TA.OptConfig(), collectives="torrent",
                           mesh=make_host_mesh(data=4), loss_chunks=2, spans=spans)
    step(p, TA.init(p), {k: torch.from_numpy(v) for k, v in _batch(B=8).items()})
    got = spans.read()
    assert {k: len(v) for k, v in got.items()} == {"fwd_bwd": 4, "reduce": 1, "optimizer": 1}
    assert all(ms >= 0 for v in got.values() for ms in v) and spans.read() == {}
