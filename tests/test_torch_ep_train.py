"""Expert parallelism inside the port's train step against the JAX
package's: deepseek-moe-16b smoke (dense layer 0, two MoE layers of 8
experts top-2) with ``moe_ep_dispatch`` on 4 virtual DP ranks, 8 x 16
tokens a step.

JAX runs ``moe_apply_ep`` on every rank at once inside the DP
``shard_map`` of ``torrent_grad_reduce``; the port runs the ranks in one
forward over the stacked view (``launch.steps.make_joint_grad_fn``) and
takes every rank's grads from one backward. One 4-device JAX subprocess
computes, on a ``("data",)`` mesh: each rank's grads and loss (the
``shard_map`` of ``torrent_grad_reduce`` without the reduction) for
``moe_ep_chains`` 1 and 2 and the int8 EP wire; two train steps on the
torrent exact wire, on int8 + error-feedback gradient reduction with
K = 2, on ``collectives="xla"`` and with 2 microbatches; and two steps
of its ``Trainer`` (exact and int8 + EF).

Routing. Top-k routing is discontinuous and the packages round bf16
at other places, so every MoE call of the port is routed as JAX's same
call routed (recorded per rank with ``jax.debug.callback``), and each
flip the port would make on its own must be a near tie
(``tests/_jax_moe_routing.py``). The Trainers run unpinned: their
losses average over every token.

JAX's ``collectives="xla"`` step does not reach expert parallelism: its
concrete mesh is not recoverable inside the scanned loss, and
``_moe_apply_ep_auto`` falls back to the flat path over the global
batch. The port's plain-mean step runs EP. At ``capacity_factor=8``
neither drops an assignment, so both compute the same function (the
same global aux), and that is where they are compared.

Tolerances (``tests/test_torch_train.py``'s): losses within 1e-3, grad
norms within 1e-2 relative, grads within 5% of each leaf's largest
element with cosine >= 0.999; Trainer losses within 5e-3 a step.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import make_joint_grad_fn, make_train_step  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.parallel.collectives import ef_residual_init, torrent_joint_grad_reduce  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from _jax_moe_routing import NEAR_TIE, flip_margins  # noqa: E402
from _moe_routing import routing_as  # noqa: E402

ARCH = "deepseek-moe-16b"
N, B, S = 4, 8, 16
STEPS = 2
OPT = dict(peak_lr=1e-2, warmup_steps=1, eps=1.0)  # a large eps keeps AdamW's step linear
TRAINER = dict(arch=ARCH, smoke=True, steps=STEPS, global_batch=B, seq_len=S, peak_lr=2e-3,
               warmup_steps=1, ckpt_every=100, loss_chunks=2, log_every=100,
               collectives="torrent", remat="none")
# per-rank grads: the MoE config of each variant
RANK_VARIANTS = {"k1": {}, "k2": {"moe_ep_chains": 2}, "int8": {"moe_ep_int8_wire": True}}
# train steps: (MoE config, step knobs)
STEP_VARIANTS = {
    "torrent": ({}, {"collectives": "torrent"}),
    "int8_ef": ({"moe_ep_chains": 2}, {"collectives": "torrent", "num_chains": 2,
                                       "compress_grads": True, "error_feedback": True}),
    "xla": ({"capacity_factor": 8.0}, {"collectives": "xla"}),
    "microbatches": ({}, {"collectives": "torrent", "microbatches": 2}),
}

_JAX = """
import dataclasses, json
from repro import configs as C
from repro.data.pipeline import MarkovSource
from repro.launch.steps import make_train_step
from repro.launch.train import Trainer, TrainConfig
from repro.models import moe as M
from repro.models import transformer as T
from repro.optim import adamw

N, B, S, STEPS = {N}, {B}, {S}, {STEPS}
RANK_VARIANTS, STEP_VARIANTS = {rank_variants}, {step_variants}
base = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), moe_ep_dispatch=True)
mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
batches = [{{k: jnp.asarray(v) for k, v in MarkovSource(base.vocab_size, S, B, seed=1).batch(i).items()}}
           for i in range(STEPS)]
params0 = T.model_init(jax.random.PRNGKey(0), base)
out = {{}}

# every MoE call's routing: per rank under EP (inside shard_map), over
# the global batch on the flat path
seen = []
ep, flat = M.moe_apply_ep, M._moe_apply_flat

def route(params, x, k):
    probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ params["router"], -1)
    return probs, jax.lax.top_k(probs, k)[1]

def recording_ep(params, x, cfg, axis_name, **kw):
    jax.debug.callback(lambda i, p, e: seen.append((int(i), np.asarray(p), np.asarray(e))),
                       jax.lax.axis_index(axis_name), *route(params, x, cfg.moe_top_k))
    return ep(params, x, cfg, axis_name, **kw)

def recording_flat(params, x, cfg):
    jax.debug.callback(lambda p, e: seen.append((-1, np.asarray(p), np.asarray(e))),
                       *route(params, x, cfg.moe_top_k))
    return flat(params, x, cfg)

M.moe_apply_ep, M._moe_apply_flat = recording_ep, recording_flat

def take_routing(name):
    # per rank in arrival order (a rank's MoE layers run in order);
    # one (N, T, E) probs and (N, T, k) experts array per call
    jax.effects_barrier()
    got, ranks = list(seen), sorted({{s[0] for s in seen}})
    seen.clear()
    per = [[s for s in got if s[0] == r] for r in ranks]
    assert len({{len(p) for p in per}}) == 1, [len(p) for p in per]
    for c in range(len(per[0])):
        out[f"{{name}}_probs{{c}}"] = np.stack([p[c][1] for p in per]).reshape(N, -1, base.num_experts)
        out[f"{{name}}_experts{{c}}"] = np.stack([p[c][2] for p in per]).reshape(N, -1, base.moe_top_k)
    out[f"{{name}}_calls"] = np.int64(len(per[0]))

def grad_fn_local(cfg):
    def fn(params, batch):
        (_, m), g = jax.value_and_grad(
            lambda p: T.loss_fn(p, cfg, batch, remat="none", loss_chunks=2), has_aux=True)(params)
        return g, m
    return fn

with jax.set_mesh(mesh):
    for name, kw in RANK_VARIANTS.items():
        local = grad_fn_local(dataclasses.replace(base, **kw))

        def per_rank(params, batch, local=local):
            # torrent_grad_reduce's shard_map, each rank's grads stacked
            def inner(p, b):
                g, m = local(p, b)
                return jax.tree.map(lambda x: x[None], g), m["loss"][None]
            return jax.shard_map(inner, mesh=mesh, in_specs=(P(), bspecs),
                                 out_specs=(P("data"), P("data")), check_vma=False)(params, batch)

        g, loss = jax.jit(per_rank)(params0, batches[0])
        take_routing(f"rank_{{name}}")
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"rank_{{name}}_grad{{i}}"] = np.asarray(leaf)
        out[f"rank_{{name}}_loss"] = np.asarray(loss)
    for name, (ckw, skw) in STEP_VARIANTS.items():
        step = jax.jit(make_train_step(dataclasses.replace(base, **ckw), adamw.OptConfig(
            peak_lr=1e-2, warmup_steps=1, eps=1.0), remat="none", mesh=mesh, batch_specs=bspecs,
            loss_chunks=2, **skw))
        p, o = params0, adamw.init(params0)
        ef = jax.tree.map(lambda x: jnp.zeros((N,) + x.shape, jnp.float32), params0)
        for i in range(STEPS):
            if skw.get("error_feedback"):
                p, o, ef, m = step(p, o, ef, batches[i])
            else:
                p, o, m = step(p, o, batches[i])
            take_routing(f"step_{{name}}{{i}}")
            out[f"step_{{name}}{{i}}_loss"] = np.asarray(m["loss"])
            out[f"step_{{name}}{{i}}_grad_norm"] = np.asarray(m["grad_norm"])

# the Trainer (its own ("data", "model") mesh), unpinned
M.moe_apply_ep, M._moe_apply_flat = ep, flat
C.get_smoke_config = lambda arch: base
losses = {{}}
for name, kw in (("exact", {{}}), ("int8_ef", {{"compress_grads": True}})):
    tc = TrainConfig(ckpt_dir={root!r} + "/" + name, **{trainer}, **kw)
    losses[name] = Trainer(tc).run()["losses"]
np.savez({path!r}, **out)
print("LOSSES", json.dumps(losses))
"""


@pytest.fixture(scope="module")
def jax_run(run_multidevice, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_train")
    stdout = run_multidevice(_JAX.format(
        N=N, B=B, S=S, STEPS=STEPS, rank_variants=RANK_VARIANTS, step_variants=STEP_VARIANTS,
        trainer=TRAINER, root=str(tmp), path=str(tmp / "out.npz")), devices=N, timeout=900)
    return dict(np.load(tmp / "out.npz")), json.loads(stdout.split("LOSSES", 1)[1])


@pytest.fixture(scope="module")
def start():
    jp = jax.device_get(JT.model_init(jax.random.PRNGKey(0), JC.get_smoke_config(ARCH)))
    batches = [{k: torch.from_numpy(v) for k, v in
                JD.MarkovSource(JC.get_smoke_config(ARCH).vocab_size, S, B, seed=1).batch(i).items()}
               for i in range(STEPS)]
    return jp, batches


def _cfg(**kw):
    return dataclasses.replace(TC.get_smoke_config(ARCH), moe_ep_dispatch=True, **kw)


def _routing(out, name):
    """JAX's routing of one run as (probs, experts) per MoE call."""
    return [(out[f"{name}_probs{c}"], out[f"{name}_experts{c}"])
            for c in range(int(out[f"{name}_calls"]))]


class _Pinned:
    """Route the port's MoE calls as JAX's recorded runs did, run after
    run; the flips of the port's own choices are collected."""

    def __init__(self, out):
        self.out, self.seen, self.flips = out, [], []

    def run(self, name, fn):
        calls = _routing(self.out, name)
        with routing_as([torch.from_numpy(e.astype(np.int64)) for _, e in calls]) as flips:
            got = fn()
        assert len(flips) == len(calls), (name, len(flips), len(calls))
        self.seen.extend(calls)
        self.flips.extend(flips)
        return got

    def check(self):
        margins = flip_margins(self.seen, self.flips)
        assert all(m <= NEAR_TIE for m in margins), margins


def _grads_close(got, want):
    g, a = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == a.shape and np.isfinite(g).all()
    span = np.abs(a).max()
    if span == 0:  # a leaf no loss reaches (the int8 wire): zero on both sides
        assert np.abs(g).max() == 0
        return
    assert np.abs(a - g).max() <= 5e-2 * span
    assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= 0.999


@pytest.mark.parametrize("variant", list(RANK_VARIANTS))
def test_per_rank_and_reduced_grads_match_jax(jax_run, start, variant):
    """Each rank's grads and loss from the joint forward and backward
    against JAX's ``shard_map`` ranks (``moe_ep_chains`` 1 and 2, the
    int8 EP wire), and the Torrent-reduced grads against the mean of
    JAX's ranks (the exact wire sums them)."""
    out, _ = jax_run
    jp, batches = start
    tp = params_from_numpy(jp, "cpu")
    cfg, mesh = _cfg(**RANK_VARIANTS[variant]), make_host_mesh(data=N)
    pin = _Pinned(out)
    joint = make_joint_grad_fn(cfg, mesh, remat="none", loss_chunks=2)
    stacked, metrics = pin.run(f"rank_{variant}", lambda: joint(tp, batches[0]))
    reduced, rmetrics = pin.run(f"rank_{variant}", lambda: torrent_joint_grad_reduce(
        joint, mesh)(tp, batches[0]))
    pin.check()
    jl = out[f"rank_{variant}_loss"]
    assert abs(float(metrics["loss"]) - float(jl.mean())) < 1e-3
    assert abs(float(rmetrics["loss"]) - float(jl.mean())) < 1e-3
    n_leaves = len(stacked)
    assert n_leaves == len(leaves(tp)) == len([k for k in out if k.startswith(f"rank_{variant}_grad")])
    for i, (st, red) in enumerate(zip(stacked, leaves(reduced))):
        want = out[f"rank_{variant}_grad{i}"]
        assert tuple(st.shape) == want.shape == (N,) + tuple(red.shape)
        for r in range(N):
            _grads_close(st[r].numpy(), want[r])
        _grads_close(red.numpy(), want.astype(np.float64).mean(0))


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_train_steps_match_jax(jax_run, start, variant):
    """Two steps of ``make_train_step`` with ``moe_ep_dispatch`` on 4
    ranks: torrent on the exact wire, int8 + error-feedback gradient
    reduction over K = 2 rings with K = 2 EP rings, the plain-mean
    (``"xla"``) step, and gradient accumulation over 2 microbatches
    (each one joint forward over the ranks); losses and grad norms
    against JAX's."""
    out, _ = jax_run
    jp, batches = start
    ckw, skw = STEP_VARIANTS[variant]
    p = params_from_numpy(jp, "cpu")
    o = TA.init(p)
    ef = ef_residual_init(p, N)
    step = make_train_step(_cfg(**ckw), TA.OptConfig(**OPT), remat="none",
                           mesh=make_host_mesh(data=N), loss_chunks=2, **skw)
    pin = _Pinned(out)
    for i in range(STEPS):
        if skw.get("error_feedback"):
            p, o, ef, m = pin.run(f"step_{variant}{i}", lambda: step(p, o, ef, batches[i]))
        else:
            p, o, m = pin.run(f"step_{variant}{i}", lambda: step(p, o, batches[i]))
        assert abs(float(m["loss"]) - float(out[f"step_{variant}{i}_loss"])) < 1e-3, i
        want_norm = float(out[f"step_{variant}{i}_grad_norm"])
        assert abs(float(m["grad_norm"]) / want_norm - 1) < 1e-2, i
    pin.check()
    if skw.get("error_feedback"):
        assert any(float(r.abs().max()) > 0 for r in leaves(ef))


def test_trainer_matches_jax_trainer(jax_run, start, tmp_path):
    """The port's ``Trainer`` (``dp=4``) against JAX's (4 virtual
    devices), both from JAX's initial params, with ``moe_ep_dispatch``,
    exact and int8 + EF gradient wire: loss trajectories within 5e-3."""
    _, jl = jax_run
    jp, _ = start
    for name, kw in (("exact", {}), ("int8_ef", {"compress_grads": True})):
        tc = TTrain.TrainConfig(dp=N, ckpt_dir=str(tmp_path / name), **TRAINER, **kw)
        got = TTrain.Trainer(tc, device="cpu", params=jp, model_cfg=_cfg()).run()["losses"]
        assert len(got) == STEPS == len(jl[name])
        assert max(abs(a - b) for a, b in zip(got, jl[name])) < 5e-3, (name, got, jl[name])


def test_remat_recompute_keeps_the_mesh(start):
    """The remat'd backward recomputes each layer group's forward, MoE
    exchange included, on the autograd engine's thread for a CUDA device,
    where the caller's ``set_mesh`` context is not set: the recompute
    carries the mesh of its forward. Here the backward runs after the
    ``set_mesh`` block has closed, as such a thread sees it, and gives the
    grads of a backward inside the block."""
    from repro_torch.models import transformer as TT
    from repro_torch.parallel import hints

    jp, batches = start
    cfg, mesh = _cfg(), make_host_mesh(data=N)

    def grads(inside: bool):
        ps = [{k: v for k, v in params_from_numpy(jp, "cpu").items()}] * N
        leaves_ = [x.requires_grad_(True) for x in leaves(ps[0])]
        with hints.set_mesh(mesh):
            losses, _ = TT.loss_fn_ranks(ps, cfg, batches[0], remat="dots", loss_chunks=2)
            if inside:
                return torch.autograd.grad(losses.sum(), leaves_)
        return torch.autograd.grad(losses.sum(), leaves_)

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)
