"""Tensor parallelism in the process form — a ``(data, model)``
``ProcessMesh``, Megatron-style TP for the dense family in the Torrent
train step and the ``Trainer``, state placed by ``param_pspecs`` —
against the port at TP = 1 and JAX's GSPMD step on a ``(data, model)``
mesh, on the CPU with gloo.

Two spawns are shared by the module (``tests/_tp_cases.py`` holds what
the ranks run): 4 ranks as ``(data=1, model=4)`` and ``(data=2,
model=2)``, and 2 ranks as ``(data=1, model=2)`` with the ``Trainer``
and its checkpoints. The smoke yi-6b has 4 query heads and 2 KV heads,
so at TP = 4 each rank holds half a KV head and gathers K/V. JAX's
reference is its own Torrent train step (``collectives="torrent"``),
jitted on 4 virtual devices as ``(2, 2)`` and ``(1, 4)`` meshes with
``param_pspecs(tp)`` shardings, in one ``run_multidevice`` subprocess.
The ``(1, 2)`` mesh is held against JAX's ``(2, 2)`` run: every mesh
computes the same function of the same global batch.

Tolerances. Loss within 1e-3 and params within atol = rtol = 2e-3 after
two steps, as JAX's own DP x TP parity test holds its step
(``tests/test_sharding_and_elastic.py``); the steps use a first AdamW
step linear in the grads (eps = 1), so a grad's rounding cannot flip an
update's sign. Grads in bf16 within 3e-2 of each leaf's max (bf16
rounding: a rank rounds its partial sums before the all-reduce; measured
1.8e-2); with both sides computing in f32 within 1e-5 of each leaf's max
(measured 8.4e-7), which shows the TP function is the same. Replicated
leaves, the clipping norm's inputs and checkpoints: bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402

import _tp_cases as tc  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import program as prg  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import make_grad_fn, make_train_step  # noqa: E402
from repro_torch.launch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.collectives import resolve_ring_chains  # noqa: E402
from repro_torch.parallel.spec import P  # noqa: E402
from repro_torch.parallel.tp import modeled_tp_bytes  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
B, S = 8, 16
LOSS_TOL, PARAM_TOL, GRAD_TOL, GRAD_F32_TOL = 1e-3, 2e-3, 3e-2, 1e-5


@pytest.fixture(scope="module")
def inputs():
    """The smoke yi-6b's params from JAX's init, and an (8, 16) batch."""
    params = jax.device_get(JT.model_init(jax.random.PRNGKey(0), JC.get_smoke_config(tc.ARCH)))
    rng = np.random.default_rng(1)
    V = JC.get_smoke_config(tc.ARCH).vocab_size
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    return params, batch


_JAX_TP = """
from jax.sharding import NamedSharding
from repro import configs as C
from repro.launch import steps as S
from repro.launch.steps import make_train_step
from repro.models import layers as L
from repro.models import transformer as T
from repro.optim import adamw
from repro.parallel import sharding as shd

d = np.load({inputs!r})
cfg = C.get_smoke_config({arch!r})
params = T.model_init(jax.random.PRNGKey(0), cfg)
batch = {{k: d[k] for k in ("tokens", "labels")}}
opt_cfg = adamw.OptConfig(**{adamw!r})
out = {{}}

def named(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

# the Torrent step on every mesh, the xla step where data is live; params
# placed by param_pspecs, AdamW's moments by opt_pspecs (ZeRO-1), as
# JAX's Trainer places them
RUNS = [((2, 2), "torrent"), ((1, 4), "torrent"), ((4, 1), "torrent"), ((2, 2), "xla"),
        ((4, 1), "xla")]
compiled = {{}}

def compile_run(shape, coll):
    mesh = mesh_of(shape)
    shapes = jax.eval_shape(lambda: params)
    pspecs = shd.param_pspecs(shapes, cfg, tp=shape[1])
    ospecs = shd.opt_pspecs(pspecs, shapes, data_size=shape[0])
    step = make_train_step(cfg, opt_cfg, collectives=coll, mesh=mesh,
                           batch_specs={{k: P("data", None) for k in batch}}, loss_chunks=2)
    bsh = {{k: NamedSharding(mesh, P("data", None)) for k in batch}}
    with jax.set_mesh(mesh):
        f = jax.jit(step, in_shardings=(named(mesh, pspecs), named(mesh, ospecs), bsh),
                    out_shardings=(named(mesh, pspecs), named(mesh, ospecs), None))
        args = (jax.tree.map(jax.device_put, params, named(mesh, pspecs)),
                jax.jit(lambda: adamw.init(params), out_shardings=named(mesh, ospecs))(),
                {{k: jax.device_put(v, bsh[k]) for k, v in batch.items()}})
        compiled[shape, coll] = (mesh, f.lower(*args).compile(), args, pspecs)

for shape, coll in RUNS:
    compile_run(shape, coll)
for shape, coll in RUNS:
    name = f"{{shape[0]}}x{{shape[1]}}/{{coll}}"
    mesh, f, (p, o, b), pspecs = compiled[shape, coll]
    with jax.set_mesh(mesh):
        if coll == "torrent" and shape[0] < 4:  # the whole batch's grads
            grads = jax.jit(jax.grad(lambda p: T.loss_fn(p, cfg, b, loss_chunks=2)[0]))(p)
            for i, g in enumerate(jax.tree.leaves(grads)):
                out[f"{{name}}/grad{{i}}"] = np.asarray(g, np.float32)
        for s in range(2):
            p, o, m = f(p, o, b)
            out[f"{{name}}/loss{{s}}"] = np.asarray(m["loss"])
            out[f"{{name}}/norm{{s}}"] = np.asarray(m["grad_norm"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{{name}}/param{{i}}"] = np.asarray(x, np.float32)
    for k in ("mu", "nu"):
        for i, x in enumerate(jax.tree.leaves(o[k])):
            out[f"{{name}}/{{k}}{{i}}"] = np.asarray(x, np.float32)

# the smoke train cells, in f32 compute, from the port's params and batch
L.COMPUTE_DTYPE = jnp.float32
cells = {cells!r}
variants = {variants!r}
C.SHAPES[{smoke_train!r}[0]] = C.Shape(*{smoke_train!r})
for name, (arch, mesh_name, coll) in cells.items():
    variant, steps = variants.get(name, ("baseline", 1))
    dp, tp = (int(n) for n in mesh_name.split("x"))
    mesh = mesh_of((dp, tp))
    cell = S.build_cell(arch, {smoke_train!r}[0], mesh, smoke=True, collectives=coll,
                        variant=variant)
    shapes = cell.args[0]
    p = jax.tree.unflatten(jax.tree.structure(shapes),
                           [d[f"cell/{{name}}/param{{i}}"] for i in range(len(jax.tree.leaves(shapes)))])
    b = {{k: jnp.asarray(d[f"cell/{{name}}/batch/{{k}}"], x.dtype) for k, x in cell.args[2].items()}}
    with jax.set_mesh(mesh):
        args = (jax.tree.map(jax.device_put, p, cell.in_shardings[0]),
                jax.jit(lambda: adamw.init(p), out_shardings=cell.in_shardings[1])(),
                {{k: jax.device_put(v, cell.in_shardings[2][k]) for k, v in b.items()}})
        f = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        for s in range(steps):
            p, o, m = f(*args)
            args = (p, o, args[2])
            out[f"cell/{{name}}/loss{{s}}"] = np.asarray(m["loss"])
            out[f"cell/{{name}}/norm{{s}}"] = np.asarray(m["grad_norm"])
    out[f"cell/{{name}}/loss"] = out[f"cell/{{name}}/loss0"]
    out[f"cell/{{name}}/norm"] = out[f"cell/{{name}}/norm0"]
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"cell/{{name}}/param{{i}}"] = np.asarray(x, np.float32)
    for i, x in enumerate(jax.tree.leaves(o["mu"])):
        out[f"cell/{{name}}/mu{{i}}"] = np.asarray(x, np.float32)

# EP under a live model axis (f32 compute): one MoE layer through
# moe_apply's moe_ep_dispatch route, and the moe-ep decode cell's serve
# step at per-slot positions (JAX's scalar GQA decode writes its bf16
# cache only in bf16 compute), on (2, 2)
import dataclasses
from repro.models import moe as JM
mesh = mesh_of((2, 2))
ecfg = dataclasses.replace(C.get_smoke_config({ep_arch!r}), moe_ep_dispatch=True)
elike = jax.eval_shape(lambda: JM.moe_init(jax.random.PRNGKey(0), ecfg))
ep = jax.tree.unflatten(jax.tree.structure(elike),
                        [d[f"ep/p{{i}}"] for i in range(len(jax.tree.leaves(elike)))])
with jax.set_mesh(mesh):
    y, aux = jax.jit(lambda p, x: JM.moe_apply(p, x, ecfg),
                     in_shardings=(named(mesh, shd.param_pspecs(elike, ecfg, tp=2)),
                                   NamedSharding(mesh, P("data", None, None))))(ep, d["ep/x"])
out["ep/out"], out["ep/aux"] = np.asarray(y), np.asarray(aux)
like = jax.eval_shape(lambda: T.model_init(jax.random.PRNGKey(0), ecfg))
p = jax.tree.unflatten(jax.tree.structure(like), [d[f"ep_decode/param{{i}}"]
                                                  for i in range(len(jax.tree.leaves(like)))])
shape = C.Shape("decode_smoke", "decode", 16, {b_ep})
cache_like = jax.eval_shape(lambda: T.init_cache(ecfg, {b_ep}, 16))
csh = S._named(mesh, shd.cache_pspecs(cache_like, ecfg, shape, tp=2))  # "pod" dropped
rows = NamedSharding(mesh, P("data"))
with jax.set_mesh(mesh):
    serve = jax.jit(S.make_serve_step(ecfg), in_shardings=(named(mesh, shd.param_pspecs(like, ecfg, tp=2)), rows, rows, csh))
    tok, cache = serve(p, d["ep_decode/tokens"], np.zeros(({b_ep},), np.int32),
                       jax.tree.map(jax.device_put, T.init_cache(ecfg, {b_ep}, 16), csh))
out["ep_decode/tokens"] = np.asarray(tok)
for i, x in enumerate(jax.tree.leaves(cache)):
    out[f"ep_decode/cache{{i}}"] = np.asarray(x, np.float32)
np.savez({out!r}, **out)
"""


def smoke_cell_inputs() -> dict:
    """The logical params (seed 0) and the whole batch (seed 1) that
    ``build_cell`` draws for each smoke train cell of
    ``tc.SMOKE_TRAIN_CELLS``, as numpy, keyed as ``_JAX_TP`` reads them."""
    from repro_torch.configs.shapes import Shape, input_specs
    from repro_torch.launch.steps import _concrete

    out = {}
    shape = Shape(*tc.SMOKE_TRAIN)
    p, x = tc.ep_inputs()
    out.update({f"ep/p{i}": v for i, v in enumerate(leaves(p))})
    out["ep/x"] = x
    # the moe-ep decode cell's draws: the params (seed 0) and the tokens (seed 1)
    cfg = C.get_smoke_config(tc.EP_ARCH)
    for i, v in enumerate(leaves(T.model_init(torch.Generator().manual_seed(0), cfg, "cpu"))):
        out[f"ep_decode/param{i}"] = v.numpy()
    out["ep_decode/tokens"] = _concrete(input_specs(cfg, Shape("decode_smoke", "decode", 16,
                                                               tc.B_EP))["tokens"],
                                        cfg.vocab_size, torch.device("cpu"), 1).numpy()
    for name, (arch, _, _) in tc.SMOKE_TRAIN_CELLS.items():
        cfg = C.get_smoke_config(arch)
        p = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
        for i, x in enumerate(leaves(p)):
            out[f"cell/{name}/param{i}"] = x.numpy()
        batch = _concrete(input_specs(cfg, shape)["batch"], cfg.vocab_size,
                          torch.device("cpu"), 1)
        for k, v in batch.items():
            # bf16 embeds go as f32 (exact); the JAX side casts them back
            out[f"cell/{name}/batch/{k}"] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def _jax_tp(run_multidevice, inputs, root):
    """JAX's Torrent train step on (2, 2), (1, 4) and (4, 1) meshes and
    its xla step on (2, 2) and (4, 1), params placed by ``param_pspecs``
    and AdamW's moments by ``opt_pspecs``: the whole batch's grads (at
    DP < 4), two steps' losses and grad norms, the params and moments
    after; and one step of each smoke train cell of
    ``tc.SMOKE_TRAIN_CELLS`` from the port's draws."""
    root.mkdir(parents=True)
    np.savez(root / "in.npz", **inputs[1], **smoke_cell_inputs())
    run_multidevice(_JAX_TP.format(inputs=str(root / "in.npz"), out=str(root / "out.npz"),
                                   arch=tc.ARCH, adamw=tc.LINEAR_ADAMW,
                                   cells=tc.SMOKE_TRAIN_CELLS, smoke_train=tc.SMOKE_TRAIN,
                                   variants=tc.CELL_VARIANTS, ep_arch=tc.EP_ARCH, b_ep=tc.B_EP),
                    devices=4)
    got = dict(np.load(root / "out.npz"))
    n = len(jax.tree.leaves(inputs[0]))
    ref = {}
    for name in ("2x2", "1x4", "4x1"):
        for coll in ("torrent", "xla"):
            if f"{name}/{coll}/loss0" not in got:
                continue
            key = name if coll == "torrent" else f"{name}/xla"
            ref[key] = {"grads": [got.get(f"{name}/{coll}/grad{i}") for i in range(n)],
                        "params": [got[f"{name}/{coll}/param{i}"] for i in range(n)],
                        "mu": [got[f"{name}/{coll}/mu{i}"] for i in range(n)],
                        "nu": [got[f"{name}/{coll}/nu{i}"] for i in range(n)],
                        "losses": [float(got[f"{name}/{coll}/loss{s}"]) for s in range(2)],
                        "norms": [float(got[f"{name}/{coll}/norm{s}"]) for s in range(2)]}
    ref["1x2"] = ref["2x2"]
    ref["cells"] = {}
    for name in tc.SMOKE_TRAIN_CELLS:
        k = len([x for x in got if x.startswith(f"cell/{name}/param")])
        steps = tc.CELL_VARIANTS.get(name, ("baseline", 1))[1]
        ref["cells"][name] = {"loss": float(got[f"cell/{name}/loss"]),
                              "grad_norm": float(got[f"cell/{name}/norm"]),
                              "losses": [float(got[f"cell/{name}/loss{s}"]) for s in range(steps)],
                              "params": [got[f"cell/{name}/param{i}"] for i in range(k)],
                              "mu": [got[f"cell/{name}/mu{i}"] for i in range(k)]}
    ref["ep"] = {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith("ep/")}
    ref["ep_decode"] = {k.split("/", 1)[1]: v for k, v in got.items()
                        if k.startswith("ep_decode/") and not k.startswith("ep_decode/param")}
    return ref


def _rows(batch: dict, dp: int, i: int) -> dict:
    n = B // dp
    return {k: torch.from_numpy(v[i * n:(i + 1) * n]) for k, v in batch.items()}


def _tp1(inputs) -> dict:
    """The port at TP = 1 (stacked view): each DP rank's first-step
    grads (bf16 and f32 compute) at DP = 1 and 2, and two steps of the
    Torrent step at DP = 1, 2 and 4 and of the xla step at DP = 2 and 4
    (whole moments: losses, grad norms, params, moments)."""
    params_np, batch = inputs
    cfg = C.get_smoke_config(tc.ARCH)
    grad_fn = make_grad_fn(cfg, loss_chunks=2)
    out = {}
    for dp in (1, 2, 4):
        params = params_from_numpy(params_np, "cpu")
        rec = {"grads": [], "grads_f32": [], "loss0": []}
        for i in range(dp if dp < 4 else 0):
            g, m = grad_fn(params, _rows(batch, dp, i))
            rec["grads"].append([x.numpy() for x in leaves(g)])
            rec["loss0"].append(float(m["loss"]))
            with tc.compute_dtype(torch.float32):
                rec["grads_f32"].append([x.numpy() for x in leaves(grad_fn(params, _rows(
                    batch, dp, i))[0])])
        for coll in ("torrent", "xla") if dp > 1 else ("torrent",):
            step = make_train_step(cfg, adamw.OptConfig(**tc.LINEAR_ADAMW), collectives=coll,
                                   mesh=make_host_mesh(data=dp), loss_chunks=2)
            p = params_from_numpy(params_np, "cpu")
            opt = adamw.init(p)
            losses, norms = [], []
            for _ in range(2):
                p, opt, m = step(p, opt, _rows(batch, 1, 0))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            run = dict(losses=losses, norms=norms, params=[x.numpy() for x in leaves(p)],
                       mu=[x.numpy() for x in leaves(opt["mu"])],
                       nu=[x.numpy() for x in leaves(opt["nu"])])
            if coll == "torrent":
                rec.update(run)
            else:
                rec["xla"] = run
        out[dp] = rec
    return out


def _stacked_trainers(inputs, root) -> dict:
    """The stacked ``Trainer`` (TP = 1) in the configs the TP = 2 one
    runs: exact with a failure at step 3 (its checkpoint is restored on
    ``(2, 2)`` and ``(4, 1)``), and int8 + EF (its checkpoint is restored
    at TP = 2)."""
    out = {}
    for name, kw in tc.TRAINER_RUNS.items():
        tr = Trainer(TrainConfig(ckpt_dir=str(root / name), **tc.TRAINER, **kw),
                     device="cpu", params=inputs[0])
        with tc.compute_dtype(torch.float32 if name == "exact" else torch.bfloat16):
            res = tr.run()
        out[name] = {"losses": res["losses"], "restarts": res["restarts"],
                     "state": [x.detach().numpy().copy() for x in leaves(tr.state)],
                     "dir": str(root / name)}
    # the EP Trainer at TP = 1: two virtual DP ranks in one forward
    cfg = dataclasses.replace(C.get_smoke_config(tc.EP_ARCH), moe_ep_dispatch=True)
    out["ep"] = {}
    for coll in ("torrent", "xla"):
        tr = Trainer(TrainConfig(ckpt_dir=str(root / f"ep_{coll}"), dp=2, collectives=coll,
                                 **tc.EP_TRAINER), device="cpu", model_cfg=cfg)
        with tc.compute_dtype(torch.float32):
            out["ep"][coll] = tr.run()["losses"]
    return out


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX package checkpoint of the smoke model's params and AdamW
    state after one step's worth of moments, and its leaves."""
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    from repro.optim import adamw as jadamw

    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    p = JT.model_init(jax.random.PRNGKey(2), JC.get_smoke_config(tc.ARCH))
    state = {"params": p, "opt": jadamw.init(p)}
    state["opt"]["mu"] = jax.tree.map(lambda x: x * 0.5, p)
    ck = JCkpt(root)
    ck.save(3, state, blocking=True)
    ck.close()
    return root, [np.asarray(x) for x in jax.tree.leaves(state)]


@pytest.fixture(scope="module")
def runs(run_multidevice, inputs, jax_ckpt, tmp_path_factory):
    """Everything the module compares, started at once so that its wall
    time is that of its longest part: the stacked ``Trainer`` runs
    first (the spawns restore its checkpoints), then JAX's subprocess,
    the 4-rank and the 2-rank spawn run beside the port's TP = 1
    references (:func:`_tp1`)."""
    root = tmp_path_factory.mktemp("tp")
    stacked = _stacked_trainers(inputs, root / "stacked")
    with ThreadPoolExecutor(3) as ex:
        jax_run = ex.submit(_jax_tp, run_multidevice, inputs, root / "jax")
        world4 = ex.submit(tdist.spawn, tc.world4_rank, 4, device="cpu", timeout_s=600,
                           args=(*inputs, str(root / "w4"), stacked["exact"]["dir"],
                                 jax_ckpt[0]))
        world2 = ex.submit(tdist.spawn, tc.world2_rank, 2, device="cpu", timeout_s=600,
                           args=(*inputs, str(root / "tp2"), stacked["int8"]["dir"],
                                 jax_ckpt[0]))
        tp1 = _tp1(inputs)
        return types.SimpleNamespace(jax=jax_run.result(), tp1=tp1, stacked=stacked,
                                     world4=world4.result(),
                                     world2=(world2.result(), str(root / "tp2")),
                                     w4_root=str(root / "w4"))


@pytest.fixture(scope="module")
def jax_tp(runs):
    return runs.jax


@pytest.fixture(scope="module")
def tp1(runs):
    return runs.tp1


@pytest.fixture(scope="module")
def stacked_trainers(runs):
    return runs.stacked


def _ranks(world4, world2, mesh: str) -> list[dict]:
    """Every rank's train case on ``mesh``."""
    if mesh == "1x2":
        return [r["train"] for r in world2[0]]
    return [r["train"][mesh] for r in world4]


@pytest.fixture(scope="module")
def spawned(runs):
    return runs.world4, runs.world2


def _max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", tc.ARCHS)
def test_shard_blocks_concatenate_to_the_leaf(arch, tp):
    """``shard_tree``'s blocks over every model coordinate concatenate
    back to each leaf, and each block has the shape JAX's spec gives a
    device (the split dim over ``tp``)."""
    cfg = C.get_smoke_config(arch)
    full = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    specs = shd.param_pspecs(full, cfg, tp=tp)
    blocks = [leaves(shd.shard_tree(full, specs, types.SimpleNamespace(
        shape={"data": 1, "model": tp}, coords={"data": 0, "model": r}))) for r in range(tp)]
    for i, (x, spec) in enumerate(zip(leaves(full), leaves(specs))):
        dims = [d for d, e in enumerate(spec) if e == "model"]
        if not dims:
            assert all(b[i] is x or torch.equal(b[i], x) for b in blocks)
            continue
        (d,) = dims
        assert all(b[i].shape[d] * tp == x.shape[d] for b in blocks)
        assert torch.equal(torch.cat([b[i] for b in blocks], d), x)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", tc.ARCHS)
def test_gather_tree_inverts_shard_tree(spawned, arch, tp):
    """On a process mesh, ``gather_tree(shard_tree(params))`` is every
    arch's smoke params again, on every rank."""
    world4, (world2, _) = spawned
    ranks = world4 if tp == 4 else world2
    for r in ranks:
        equal, shapes = r["round_trip"][arch]
        assert equal


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rank_holds_the_shards_jax_param_pspecs_place(spawned, inputs, mesh):
    """Each rank's params have the shapes JAX's ``param_pspecs(tp)``
    leaves on a device of the mesh."""
    dp, tp = MESHES[mesh]
    cfg = JC.get_smoke_config(tc.ARCH)
    specs = jshd.param_pspecs(jax.eval_shape(lambda: inputs[0]), cfg, tp=tp)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = [tuple(s // (tp if e == "model" else 1) for s, e in
                  zip(x.shape, tuple(spec) + (None,) * (x.ndim - len(spec))))
            for x, spec in zip(jax.tree.leaves(inputs[0]), spec_leaves)]
    for r in _ranks(*spawned, mesh):
        assert r["shard_shapes"] == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_rows_follow_the_dp_coordinate(spawned, inputs, mesh):
    """``make_device_placer(mesh, spec)`` gives a rank the rows of its
    DP coordinate, the same on every TP rank of it."""
    dp, tp = MESHES[mesh]
    for r in _ranks(*spawned, mesh):
        n = B // dp
        assert np.array_equal(r["rows"], inputs[1]["tokens"][r["dp_index"] * n:
                                                              (r["dp_index"] + 1) * n])


def test_mesh_groups(spawned):
    """The model groups are consecutive ranks; the DP groups of a
    ``(data=2, model=2)`` mesh join equal model coordinates; a mesh whose
    DP axes have size 1 gives each rank a group of its own."""
    world4, (world2, _) = spawned
    for r, out in enumerate(world4):
        m = out["mesh"]["2x2"]
        assert m["coords"] == {"data": r // 2, "model": r % 2}
        assert m["model"] == (r % 2, 2) and m["data"] == (r // 2, 2) and m["dp"] == (r // 2, 2)
        assert m["all"] == (r, 4) and m["dp_index"] == r // 2
        m = out["mesh"]["1x4"]
        assert m["model"] == (r, 4) and m["dp"] == (0, 1) and m["dp_index"] == 0
    for r, out in enumerate(world2):
        assert out["mesh"]["model"] == (r, 2) and out["mesh"]["data"] == (0, 1)


# ---------------------------------------------------------------------------
# The conjugate ops and the vocab-parallel CE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["copy", "reduce", "gather", "ce"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_conjugate_ops_match_their_definitions(spawned, mesh, op):
    """Forward and backward of each op on every rank against its
    definition (``tests/_tp_cases.ops_rank``), from numpy."""
    world4, (world2, _) = spawned
    tp = MESHES[mesh][1]
    outs = [r["ops"][mesh] if mesh != "1x2" else r["ops"] for r in
            (world4 if mesh != "1x2" else world2)]
    coords = [r["mesh"][mesh]["coords"]["model"] if mesh != "1x2" else r["mesh"]["coords"]["model"]
              for r in (world4 if mesh != "1x2" else world2)]
    xs = [tc.ops_inputs(i)[0] for i in range(tp)]
    ws = [tc.ops_inputs(i)[1] for i in range(tp)]
    logits, labels = tc.ce_inputs()
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    soft = np.exp(logits - lse[:, None])
    onehot = np.eye(logits.shape[1])[labels]
    for out, i in zip(outs, coords):
        if op == "ce":
            ce, zl, grad = out["ce"]
            V = logits.shape[1] // tp
            want = (soft * (1 + 2e-2 * lse[:, None]) - onehot)[:, i * V:(i + 1) * V]
            assert abs(ce - (lse - logits[np.arange(len(labels)), labels]).sum()) < 1e-4
            assert abs(zl - 1e-2 * (lse ** 2).sum()) < 1e-4
            np.testing.assert_allclose(grad, want, atol=1e-5, rtol=1e-5)
            continue
        y, g = out[op]
        if op == "copy":
            want_y, want_g = xs[i], sum(ws)
        elif op == "reduce":
            want_y, want_g = sum(xs), ws[i]
        else:
            want_y, want_g = np.concatenate(xs, 1), sum(ws)
        np.testing.assert_allclose(y, want_y, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g, want_g, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_step_grads_match_tp1_and_jax(spawned, tp1, jax_tp, mesh):
    """Each rank's grads of its DP rows, gathered, against the port at
    TP = 1 on the same rows (bf16, and both in f32) and, where the rank
    holds the whole batch, JAX's grads on the mesh."""
    dp = MESHES[mesh][0]
    for r in _ranks(*spawned, mesh):
        ref = tp1[dp]
        i = r["dp_index"]
        assert abs(r["loss0"] - ref["loss0"][i]) < LOSS_TOL
        for got, want in zip(r["grads"], ref["grads"][i]):
            assert _max_rel(got, want) < GRAD_TOL
        for got, want in zip(r["grads_f32"], ref["grads_f32"][i]):
            assert _max_rel(got, want) < GRAD_F32_TOL
        if dp == 1:
            for got, want in zip(r["grads"], jax_tp[mesh]["grads"]):
                assert _max_rel(got, want) < GRAD_TOL


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_steps_match_tp1_and_jax(spawned, tp1, jax_tp, mesh):
    """Two Torrent train steps: losses within 1e-3 and updated params
    within 2e-3 of the port at TP = 1 and of JAX's step on its
    ``(data, model)`` mesh; the grad norms agree as closely."""
    dp = MESHES[mesh][0]
    for r in _ranks(*spawned, mesh):
        for ref in (tp1[dp], jax_tp[mesh]):
            assert np.allclose(r["losses"], ref["losses"], atol=LOSS_TOL, rtol=0)
            assert np.allclose(r["grad_norms"], ref["norms"], atol=LOSS_TOL, rtol=LOSS_TOL)
            for got, want in zip(r["params"], ref["params"]):
                np.testing.assert_allclose(got, want, atol=PARAM_TOL, rtol=PARAM_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_leaves_are_bit_equal_across_tp_ranks(spawned, mesh):
    """After two steps, every leaf no spec splits holds the same bits on
    every TP rank of a group (and so does every split leaf, gathered)."""
    ranks = _ranks(*spawned, mesh)
    groups = {}
    for r in ranks:
        groups.setdefault(r["dp_index"], []).append(r)
    for members in groups.values():
        first = members[0]
        assert len(members) == MESHES[mesh][1]
        for other in members[1:]:
            for split, a, b in zip(first["split"], first["local"], other["local"]):
                if not split:
                    assert np.array_equal(a, b)
            assert all(np.array_equal(a, b) for a, b in zip(first["params"], other["params"]))
            assert other["losses"] == first["losses"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_clip_norm_is_the_logical_trees(spawned, mesh):
    """``global_norm`` of a rank's shards over the model group equals the
    norm of the gathered tree (and numpy's), so clipping matches JAX's."""
    for r in _ranks(*spawned, mesh):
        got, gathered = r["norm"]
        want = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in r["grads"]))
        assert abs(got - gathered) <= 1e-6 * gathered
        assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_wire_bytes_are_program_wire_bytes_of_the_shards(spawned, mesh):
    """Each rank's DP reduce sends ``program_wire_bytes`` of its shards
    (its chain all-reduce over the DP group, leaf by leaf); at DP = 1
    nothing."""
    dp = MESHES[mesh][0]
    for r in _ranks(*spawned, mesh):
        want = 0
        if dp > 1:
            for nbytes in r["shard_bytes"]:
                _, rings = resolve_ring_chains(dp, nbytes)
                want += prg.program_wire_bytes(prg.plan_all_reduce(dp, rings), nbytes)
        assert r["dp_wire_bytes"] == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_payload_bytes_match_their_model(spawned, mesh):
    """The payload bytes a rank hands the model group's collectives in
    one step equal ``modeled_tp_bytes`` (two bf16 all-reduces of B·S·d a
    layer forward and backward, the remat'd recompute, the embedding, the
    CE's reductions, the K/V gather at TP = 4)."""
    dp, tp = MESHES[mesh]
    want = modeled_tp_bytes(C.get_smoke_config(tc.ARCH), B // dp * S, tp)
    for r in _ranks(*spawned, mesh):
        assert r["tp_bytes"] == want


@pytest.mark.parametrize("name", list(tc.LEFT_OUT) + ["heads", "moe_ep", "prefill",
                                                      "seq_flash"])
def test_left_out_families_raise_naming_their_item(spawned, name):
    """Under a live model axis (TP = 2): the families once left out
    (qwen2-vl's M-RoPE, whisper's encoder-decoder) train, qwen2-vl
    prefills and a MoE config with ``moe_ep_dispatch`` trains (EP over
    the one-rank DP group composed with experts over ``model``)
    (``None``: no refusal); a dense config whose heads the TP size does
    not divide raises ``NotImplementedError`` naming ``attn_seq_shard``,
    and ``attn_seq_shard`` with the flash kernel naming both (the kernel
    takes no query offset)."""
    world4, (world2, _) = spawned
    words = {"heads": ("num_heads=3", "attn_seq_shard"),
             "seq_flash": ("attn_seq_shard", "flash", "query offset")}
    for r in world2:
        msg = r["refusals"][name]
        if name in words:
            assert msg is not None and all(w in msg for w in words[name]), msg
        else:
            assert msg is None, msg


# ---------------------------------------------------------------------------
# The Trainer and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(tc.TRAINER_RUNS))
def test_trainer_tp2_matches_tp1(spawned, stacked_trainers, name):
    """``Trainer(TrainConfig(tp=2))`` in the process form against the
    stacked ``Trainer`` from the same params, six steps: losses within
    1e-3 a step. The exact run (f32 compute) goes across a failure and a
    restart from the step-2 checkpoint, and its gathered state (params,
    AdamW moments) is within 2e-3. The int8 + EF run computes in bf16,
    whose rounding AdamW's sign-like first updates amplify past 2e-3 in
    a few elements, so its state is not compared; its EF residual is
    shaped as each rank's shards."""
    _, (world2, _) = spawned
    ref = stacked_trainers[name]
    for r in world2:
        got = r[name]
        assert got["restarts"] == ref["restarts"] == (1 if name == "exact" else 0)
        assert got["rows"] == (0, 8)
        assert np.allclose(got["losses"], ref["losses"], atol=LOSS_TOL, rtol=0)
        if name == "exact":
            for a, b in zip(got["state"], ref["state"]):
                np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)
        else:
            shapes = world2[0]["train"]["shard_shapes"]
            assert got["ef_shapes"] == [(1,) + s for s in shapes]
    assert world2[0][name]["state"][0].shape == ref["state"][0].shape


def test_trainer_seed_init_is_the_logical_model(spawned):
    """The TP = 2 ``Trainer``'s seeded init, each leaf cut to the rank's
    block as it is drawn, gathers to ``model_init``'s whole model from the
    same seed, bit for bit."""
    _, (world2, _) = spawned
    assert all(r["seed_init_equal"] for r in world2)


def test_tp2_checkpoint_restores_at_tp1_stacked_and_in_jax(spawned):
    """The TP = 2 Trainer's last checkpoint holds the logical leaves: the
    process form at TP = 1, the stacked form and the JAX package restore
    the gathered state bit for bit."""
    from repro.checkpoint.manager import CheckpointManager as JCkpt

    _, (world2, root) = spawned
    d = os.path.join(root, "tp2_exact")
    want = world2[0]["exact"]["state"]
    # the process form at TP = 1 (params and AdamW state, every leaf whole)
    assert all(np.array_equal(a, b) for a, b in zip(world2[1]["tp1_restore"], want))
    cfg = C.get_smoke_config(tc.ARCH)
    p = T.model_init(torch.Generator().manual_seed(1), cfg, "cpu")
    ckpt = CheckpointManager(d)
    got = ckpt.restore(ckpt.latest_step(), {"params": p, "opt": adamw.init(p)})
    ckpt.close()
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(leaves(got), want))
    jp = JT.model_init(jax.random.PRNGKey(1), JC.get_smoke_config(tc.ARCH))
    from repro.optim import adamw as jadamw

    jck = JCkpt(d)
    jgot = jck.restore(jck.latest_step(), {"params": jp, "opt": jadamw.init(jp)})
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(jax.tree.leaves(jgot), want))


def test_stacked_checkpoint_restores_as_tp2_shards(spawned, stacked_trainers):
    """The stacked int8 + EF ``Trainer``'s checkpoint restored with
    ``specs=``/``mesh=`` on a ``(data=1, model=2)`` mesh is each rank's
    block of every leaf (the EF row split as its param), bit for bit."""
    _, (world2, _) = spawned
    ref = stacked_trainers["int8"]["state"]
    cfg = C.get_smoke_config(tc.ARCH)
    specs = shd.state_specs(shd.logical_pspecs(cfg, 2), make_host_mesh(), ef=True)
    for r, out in enumerate(world2):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                     coords={"data": 0, "model": r})
        order = leaves(specs)
        want = [np.asarray(shd.shard_tree(x, s, mesh)) for x, s in zip(ref, order)]
        assert len(out["tp2_restore"]) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(out["tp2_restore"], want))


def test_jax_checkpoint_restores_as_tp2_shards(spawned, jax_ckpt):
    """A checkpoint the JAX package wrote restores on a ``(data=1,
    model=2)`` mesh as each rank's block of every leaf, bit for bit."""
    _, (world2, _) = spawned
    cfg = C.get_smoke_config(tc.ARCH)
    specs = shd.state_specs(shd.logical_pspecs(cfg, 2), make_host_mesh())
    for r, out in enumerate(world2):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                     coords={"data": 0, "model": r})
        want = [np.asarray(shd.shard_tree(x, s, mesh)) for x, s in zip(jax_ckpt[1],
                                                                       leaves(specs))]
        assert len(out["jax_restore"]) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(out["jax_restore"], want))


def test_reshard_state_places_this_ranks_shards(spawned):
    """``reshard_state(state, mesh, specs)`` (JAX's signature) on a
    ``(data=1, model=2)`` mesh gives each rank its block of every leaf of
    a logical state (numpy arrays and tensors alike)."""
    _, (world2, _) = spawned
    for r in world2:
        assert r["reshard_equal"]
        assert r["reshard_shapes"] == r["train"]["shard_shapes"]


def test_stacked_view_refuses_a_model_axis():
    """The stacked ``VirtualMesh`` has no TP form: it points to
    ``ProcessMesh``; the stacked ``Trainer`` at ``tp=2`` refuses too."""
    with pytest.raises(NotImplementedError, match="ProcessMesh"):
        make_host_mesh(data=1, model=2)
    with pytest.raises(NotImplementedError, match="ProcessMesh"):
        Trainer(TrainConfig(tp=2, steps=1), device="cpu")


# ---------------------------------------------------------------------------
# ZeRO-1 in the process form: AdamW's moments placed over data by opt_pspecs
# ---------------------------------------------------------------------------

ZMESHES = {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
ZERO1_MESHES = ["2x1", "2x2", "4x1"]  # the meshes whose data axis is live
# the xla step in the process form against the stacked xla step: the
# ranks' grads summed by the backend's all-reduce, in another order than
# the stacked step's running sum (two ranks: one rounding either way, so
# bit for bit); within f32 rounding of sums in another order, as
# tests/test_torch_dist.py holds its microbatched step (measured on
# (4, 1): 3.7e-9 after two steps)
XLA_RTOL, XLA_ATOL = 1e-5, 1e-6
# moments against JAX's after two bf16 steps: mu is linear in the grads,
# held as bf16 grads are (GRAD_TOL of each leaf's max); nu is quadratic,
# twice that
MU_TOL, NU_TOL = GRAD_TOL, 2 * GRAD_TOL
# the smoke train cells against JAX's cell, both in f32 compute: the
# bounds of tests/test_torch_cell.py's train cells (loss 1e-3, grad norm
# 1e-2 relative, mu within 5% of each leaf's max at cosine >= 0.999),
# params within PARAM_TOL
CELL_GRAD_NORM_REL, CELL_MU_REL, CELL_MU_COS = 1e-2, 5e-2, 0.999


def _coords(mesh: str, rank: int):
    dp, tp = ZMESHES[mesh]
    return types.SimpleNamespace(shape={"data": dp, "model": tp},
                                 coords={"data": rank // tp, "model": rank % tp})


def _zranks(spawned, mesh: str) -> list[dict]:
    world4, (world2, _) = spawned
    return [r["zero1"][mesh] for r in (world2 if mesh == "2x1" else world4)]


def _jax_opt_specs(inputs, tp: int, dp: int):
    cfg = JC.get_smoke_config(tc.ARCH)
    shapes = jax.eval_shape(lambda: inputs[0])
    pspecs = jshd.param_pspecs(shapes, cfg, tp=tp)
    return jax.tree.leaves(jshd.opt_pspecs(pspecs, shapes, data_size=dp)["mu"],
                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _block(x: np.ndarray, spec, mesh) -> np.ndarray:
    """``x``'s block on ``mesh``'s rank by ``spec`` (a port, a JAX or a
    tuple spec)."""
    return np.asarray(shd.shard_tree(x, P(*spec), mesh))


@pytest.mark.parametrize("mesh", ZERO1_MESHES)
def test_zero1_moments_are_the_blocks_of_opt_pspecs(spawned, inputs, mesh):
    """On a process mesh with a live ``data`` axis each rank's ``mu`` and
    ``nu`` have the block shapes JAX's ``opt_pspecs`` leave on a device
    of the mesh, and are allocated at that size: on ``(2, 1)`` and
    ``(4, 1)`` (TP = 1) a rank's moment bytes are the whole moments'
    over the DP size, never the whole."""
    dp, tp = ZMESHES[mesh]
    specs = _jax_opt_specs(inputs, tp, dp)
    for r, got in enumerate(_zranks(spawned, mesh)):
        m = _coords(mesh, r)
        want = [_block(np.empty(x.shape, np.uint8), s, m).shape
                for x, s in zip(jax.tree.leaves(inputs[0]), specs)]
        assert got["moment_shapes"] == want
        assert got["moment_bytes"] < got["whole_moment_bytes"]
        if tp == 1:
            assert got["moment_bytes"] * dp == got["whole_moment_bytes"]


@pytest.mark.parametrize("mesh", ZERO1_MESHES)
def test_zero1_block_update_is_the_whole_updates_slice(spawned, mesh):
    """``adamw.update_zero1`` on a rank's moment blocks against
    ``adamw.update`` on whole moments, from the same reduced grads: the
    params (the blocks all-gathered over ``data``) and each moment block
    equal to that slice of the whole update, bit for bit."""
    for got in _zranks(spawned, mesh):
        assert got["block_update_bit_equal"] == {"params": True, "mu": True, "nu": True}


@pytest.mark.parametrize("mesh", ZERO1_MESHES)
def test_zero1_gather_moves_the_other_ranks_blocks(spawned, mesh):
    """The param all-gather moves a rank ``(dp - 1) / dp`` of its param
    bytes a step (every leaf of the smoke model splits over ``data``),
    and the step records it as a ``param_gather`` span beside
    ``fwd_bwd``, ``reduce`` and ``optimizer``."""
    dp = ZMESHES[mesh][0]
    for got in _zranks(spawned, mesh):
        assert got["split_param_bytes"] == got["param_bytes"]
        for coll in ("torrent", "xla"):
            assert got[coll]["gather_bytes"] * dp == got["param_bytes"] * (dp - 1)
            assert {"fwd_bwd", "reduce", "optimizer", "param_gather"} <= set(got[coll]["spans"])


@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_zero1_steps_match_the_stacked_step_bit_for_bit(spawned, tp1, mesh):
    """Two Torrent steps with ZeRO-1 (TP = 1) against the stacked step's
    (whole moments, virtual ranks) from the same params and batch: the
    params, and each rank's moment blocks against that slice of the
    stacked moments, bit for bit."""
    dp = ZMESHES[mesh][0]
    cfg = C.get_smoke_config(tc.ARCH)
    specs = leaves(shd.opt_pspecs(shd.logical_pspecs(cfg, 1), shd.logical_params(cfg), dp)["mu"])
    want = tp1[dp]
    for r, got in enumerate(_zranks(spawned, mesh)):
        run, m = got["torrent"], _coords(mesh, r)
        assert np.allclose(run["losses"], want["losses"], rtol=XLA_RTOL, atol=0)
        assert all(np.array_equal(a, b) for a, b in zip(run["params"], want["params"]))
        for k in ("mu", "nu"):
            assert all(np.array_equal(a, _block(b, s, m))
                       for a, b, s in zip(run[k], want[k], specs))


@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_xla_process_step_matches_the_stacked_xla_step(spawned, tp1, mesh):
    """``collectives="xla"`` in the process form (the backend's
    all-reduce of the ranks' grads, divided by the DP size) against the
    stacked xla step: bit for bit on two ranks, within ``XLA_RTOL`` /
    ``XLA_ATOL`` on four (the sums' order)."""
    dp = ZMESHES[mesh][0]
    want = tp1[dp]["xla"]
    for got in _zranks(spawned, mesh):
        run = got["xla"]
        for a, b in zip(run["params"], want["params"]):
            if dp == 2:
                assert np.array_equal(a, b)
            np.testing.assert_allclose(a, b, rtol=XLA_RTOL, atol=XLA_ATOL)
        assert np.allclose(run["losses"], want["losses"], rtol=XLA_RTOL, atol=0)


@pytest.mark.parametrize("coll", ["torrent", "xla"])
@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_zero1_steps_match_jax_sharded_step(spawned, jax_tp, inputs, mesh, coll):
    """Two steps on ``(2, 2)`` and ``(4, 1)`` against JAX's step jitted
    on the same mesh with params placed by ``param_pspecs`` and moments
    by ``opt_pspecs``: losses within 1e-3, params within atol = rtol =
    2e-3 (the eps = 1 first step), and each rank's ``mu``/``nu`` blocks
    against ``shard_tree`` of JAX's gathered moments by the rank's
    ``opt_pspecs`` (same shapes; within ``MU_TOL``/``NU_TOL`` of each
    leaf's max)."""
    dp, tp = ZMESHES[mesh]
    ref = jax_tp[mesh if coll == "torrent" else f"{mesh}/xla"]
    specs = _jax_opt_specs(inputs, tp, dp)
    for r, got in enumerate(_zranks(spawned, mesh)):
        run, m = got[coll], _coords(mesh, r)
        assert np.allclose(run["losses"], ref["losses"], atol=LOSS_TOL, rtol=0)
        for a, b in zip(run["params"], ref["params"]):
            np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)
        for k, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
            for a, b, s in zip(run[k], ref[k], specs):
                want = _block(b, s, m)
                assert a.shape == want.shape
                assert np.abs(a - want).max() <= tol * max(np.abs(b).max(), 1e-30)


def test_zero1_trainer_matches_stacked_trainer(spawned, stacked_trainers):
    """The ``Trainer`` on ``(2, 2)`` (TP = 2 and ZeRO-1 over ``data``)
    against the stacked ``Trainer`` from the same params, six exact
    steps in f32 compute across a failure and a restart from its
    ZeRO-1 checkpoint: losses within 1e-3 a step, the gathered state
    within 2e-3, the moments held as blocks."""
    world4, _ = spawned
    ref = stacked_trainers["exact"]
    for r in world4:
        got = r["trainer"]
        assert got["restarts"] == ref["restarts"] == 1
        assert np.allclose(got["losses"], ref["losses"], atol=LOSS_TOL, rtol=0)
        for a, b in zip(got["state"], ref["state"]):
            np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)
    assert world4[0]["trainer"]["moment_shapes"] == world4[0]["zero1"]["2x2"]["moment_shapes"]


@pytest.mark.parametrize("where", ["4x1", "1x1", "stacked", "jax"])
def test_zero1_checkpoint_restores_anywhere(spawned, runs, where):
    """The ``(2, 2)`` Trainer's last checkpoint (written from ZeRO-1
    blocks) holds the logical leaves: restored on ``(4, 1)`` each rank
    gets its blocks of the gathered state; in one process (``(1, 1)``),
    in the stacked ``Trainer``'s tree and in the JAX package, the
    gathered state itself; bit for bit."""
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    from repro.optim import adamw as jadamw

    world4, _ = spawned
    want = world4[0]["trainer"]["state"]
    d = os.path.join(runs.w4_root, "zero1_2x2")
    cfg = C.get_smoke_config(tc.ARCH)
    if where == "4x1":
        specs = leaves(shd.train_state_specs(cfg, types.SimpleNamespace(
            shape={"data": 4, "model": 1})))
        for r, out in enumerate(world4):
            m = _coords("4x1", r)
            assert all(np.array_equal(a, _block(b, s, m)) for a, b, s in
                       zip(out["restore"]["2x2_at_4x1"], want, specs))
        return
    if where == "jax":
        jp = JT.model_init(jax.random.PRNGKey(1), JC.get_smoke_config(tc.ARCH))
        jck = JCkpt(d)
        got = [np.asarray(x) for x in jax.tree.leaves(
            jck.restore(jck.latest_step(), {"params": jp, "opt": jadamw.init(jp)}))]
    else:
        p = T.model_init(torch.Generator().manual_seed(1), cfg, "cpu")
        if where == "stacked":
            tr = Trainer(TrainConfig(ckpt_dir=d, dp=2, **tc.TRAINER), device="cpu")
            like = tr.state
        else:
            like = {"params": p, "opt": adamw.init(p)}
        ckpt = CheckpointManager(d)
        got = [x.numpy() for x in leaves(ckpt.restore(ckpt.latest_step(), like))]
        ckpt.close()
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("writer,mesh", [("stacked", "2x2"), ("stacked", "4x1"),
                                         ("jax", "2x2")])
def test_stacked_checkpoint_restores_as_zero1_blocks(spawned, stacked_trainers, jax_ckpt,
                                                     writer, mesh):
    """The stacked ``Trainer``'s checkpoint (whole moments) restored on
    ``(2, 2)`` and ``(4, 1)``, and the JAX package's on ``(2, 2)``: each
    rank's TP shards of the params and ZeRO-1 blocks of the moments, bit
    for bit."""
    world4, _ = spawned
    cfg = C.get_smoke_config(tc.ARCH)
    dp, tp = ZMESHES[mesh]
    specs = leaves(shd.train_state_specs(cfg, types.SimpleNamespace(
        shape={"data": dp, "model": tp})))
    want = stacked_trainers["exact"]["state"] if writer == "stacked" else jax_ckpt[1]
    for r, out in enumerate(world4):
        m = _coords(mesh, r)
        got = out["restore"][f"{writer}_at_{mesh}"]
        assert len(got) == len(want)
        assert all(np.array_equal(a, _block(b, s, m)) for a, b, s in zip(got, want, specs))


TRAIN_CELL_MESHES = {"2x2": tc.CELL_ARCHS, "4x1": tc.CELL_ARCHS,
                     "2x1": ("qwen2-vl-7b", "whisper-tiny"), "1x4": tc.CELL_ARCHS,
                     "1x4/opt-seq": ("whisper-tiny",)}


@pytest.mark.parametrize("mesh,arch", [(m, a) for m, archs in TRAIN_CELL_MESHES.items()
                                       for a in archs])
def test_train_cells_build_on_process_meshes(spawned, mesh, arch):
    """``build_cell(arch, "train_4k", ProcessMesh)`` at full width builds
    on the meta device for all ten archs on ``(2, 2)``, ``(4, 1)`` and
    ``(1, 4)``, and for qwen2-vl-7b and whisper-tiny on ``(2, 1)``: the
    args are the rank's param shards, its ZeRO-1 moment blocks and its
    batch rows, as JAX's ``in_specs`` place the logical args of JAX's
    cell on the rank's device; ``in_specs``/``out_specs`` are JAX's.
    whisper-tiny's 6 heads at TP = 4 build only as ``opt-seq`` (its
    baseline cell raises naming ``attn_seq_shard``)."""
    world4, (world2, _) = spawned
    mesh, _, variant = mesh.partition("/")
    variant = variant or "baseline"
    dp, tp = ZMESHES[mesh]
    key = mesh if variant == "baseline" else f"{mesh}/{variant}"
    if arch == "whisper-tiny" and tp == 4 and variant == "baseline":
        for out in world4:
            msg = out["meta_cells"][key][arch].get("refused")
            assert msg is not None and "attn_seq_shard" in msg and "num_heads=6" in msg
        return
    jmesh = jax.sharding.AbstractMesh((dp, tp), ("data", "model"))
    want = JS.build_cell(arch, "train_4k", jmesh, variant=variant)
    jspecs = [[tuple(s.spec) for s in jax.tree.leaves(
        t, is_leaf=lambda x: isinstance(x, NamedSharding))] for t in want.in_shardings]
    jargs = [jax.tree.leaves(a) for a in want.args]
    for r, out in enumerate(world2 if mesh == "2x1" else world4):
        got = out["meta_cells"][key][arch]
        assert got["meta"]
        assert got["in_specs"] == jspecs
        assert got["out_specs"][:2] == jspecs[:2] and got["out_specs"][2] is None
        m = _coords(mesh, r)
        for shapes, xs, specs in zip(got["args"], jargs, jspecs):
            assert shapes == [_block(np.empty(x.shape, np.uint8), s, m).shape
                              for x, s in zip(xs, specs)]


@pytest.mark.parametrize("shape", tc.SERVE_SHAPES)
@pytest.mark.parametrize("arch", tc.CELL_ARCHS)
def test_serve_cells_build_over_data(spawned, arch, shape):
    """``build_cell(arch, "prefill_32k" | "decode_32k", ProcessMesh)`` on
    ``(4, 1)`` (pure DP; a flat MoE's capacity is the global batch's)
    builds on the meta device for all ten archs: each arg is the rank's
    block of JAX's cell's logical arg by JAX's ``in_specs`` on the same
    mesh, and the specs are JAX's."""
    world4, _ = spawned
    jmesh = jax.sharding.AbstractMesh((4, 1), ("data", "model"))
    want = JS.build_cell(arch, shape, jmesh)
    jspecs = [[tuple(s.spec) for s in jax.tree.leaves(
        t, is_leaf=lambda x: isinstance(x, NamedSharding))] for t in want.in_shardings]
    jargs = [jax.tree.leaves(a) for a in want.args]
    for r, out in enumerate(world4):
        got = out["meta_cells"][f"4x1/{shape}"][arch]
        assert got["meta"] and got["in_specs"] == jspecs
        for shapes, xs, specs in zip(got["args"], jargs, jspecs):
            # by arithmetic: a 32k decode cache is too large to allocate here
            assert shapes == [tuple(d // (4 if e is not None and "data" in (
                (e,) if isinstance(e, str) else e) else 1) for d, e in
                zip(x.shape, tuple(s) + (None,) * (len(x.shape) - len(s))))
                for x, s in zip(xs, specs)]


@pytest.mark.parametrize("name", list(tc.SMOKE_TRAIN_CELLS))
def test_smoke_train_cells_match_jax_cell(spawned, jax_tp, name):
    """One step of the smoke train cell on its process mesh (yi-6b,
    deepseek-moe-16b with the Torrent reduce and with xla, qwen2-vl-7b
    and whisper-tiny, each on ``(2, 2)``), two of deepseek-moe-16b's
    ``moe-ep`` cell (EP over ``data`` under a live ``model`` axis),
    against JAX's cell jitted on
    the same mesh from the same draws, both in f32 compute: the losses,
    the grad norm, each rank's ``mu`` blocks against its slice of JAX's,
    the gathered params, every param moved, and the payload
    ``modeled_tp_bytes`` gives (with the xla step's MoE count exchange,
    ``dp``). The MoE Torrent cell takes
    each rank's own capacity as JAX's ``shard_map`` ranks do; its xla
    cell the global batch's, as JAX's GSPMD step does."""
    world4, (world2, _) = spawned
    arch, mesh, coll = tc.SMOKE_TRAIN_CELLS[name]
    dp, tp = ZMESHES[mesh]
    ref = jax_tp["cells"][name]
    # the model group's payload and, in the xla step, a flat MoE's count
    # exchange over data (f32 compute)
    rows = tc.SMOKE_TRAIN[3] // dp
    with tc.compute_dtype(torch.float32):
        payload = modeled_tp_bytes(C.get_smoke_config(arch), rows * tc.SMOKE_TRAIN[2], tp,
                                   enc_tokens=rows * C.get_smoke_config(arch).encoder_seq_len,
                                   dp=dp if coll == "xla" else 1)
    cfg = JC.get_smoke_config(arch)
    like = jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0), cfg))
    pspecs = jshd.param_pspecs(like, cfg, tp=tp)
    specs = jax.tree.leaves(jshd.opt_pspecs(pspecs, like, data_size=dp)["mu"],
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    steps = tc.CELL_VARIANTS.get(name, ("baseline", 1))[1]
    for r, out in enumerate(world2 if mesh == "2x1" else world4):
        got, m = out["smoke_cells"][name], _coords(mesh, r)
        assert got["step"] == steps and got["moved"]
        assert np.allclose(got["losses"], ref["losses"], atol=LOSS_TOL, rtol=0)
        assert got["tp_bytes"] == payload
        assert abs(got["loss"] - ref["loss"]) < LOSS_TOL
        assert abs(got["grad_norm"] / ref["grad_norm"] - 1) < CELL_GRAD_NORM_REL
        for a, b, s in zip(got["mu"], ref["mu"], specs):
            w = _block(b, s, m).astype(np.float64)
            g = a.astype(np.float64)
            assert g.shape == w.shape and np.isfinite(g).all()
            assert np.abs(g - w).max() <= CELL_MU_REL * max(np.abs(w).max(), 1e-30)
            if np.abs(w).max() > 0:
                assert (g * w).sum() / np.sqrt((g * g).sum() * (w * w).sum()) >= CELL_MU_COS
        for a, b in zip(got["params"], ref["params"]):
            np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)


# ---------------------------------------------------------------------------
# Expert parallelism under a live model axis
# ---------------------------------------------------------------------------

# f32 compute on both sides: a MoE layer's output against JAX's within
# EP_TOL of its max (the expert sums in another order), the aux loss as
# close; routing on equal inputs is exact
EP_TOL = 1e-5


def test_ep_layer_under_tp_matches_jax(spawned, jax_tp):
    """One MoE layer of the smoke deepseek-moe-16b (8 experts, top-2)
    through ``moe_ep_dispatch`` on ``(2, 2)``: EP over ``data`` (data
    rank ``d`` owning experts ``[4d, 4d + 4)``) composed with the
    experts' ``param_pspecs`` blocks over ``model``, so ranks ``(0, 1)``
    and ``(1, 0)`` run no expert; each rank's rows of the output within
    1e-5 of the max of JAX's ``_moe_apply_ep_auto`` on a ``(2, 2)``
    mesh, its aux loss equal to 1e-6, and the ranks of a model column
    bit-equal."""
    world4, _ = spawned
    ref = jax_tp["ep"]
    n = tc.B_EP // 2
    for r, out in enumerate(world4):
        got = out["ep"]["layer"]
        d = r // 2
        assert _max_rel(got["out"], ref["out"][d * n:(d + 1) * n]) < EP_TOL
        assert abs(got["aux"] - float(ref["aux"])) < 1e-6
    for d in range(2):
        assert np.array_equal(world4[2 * d]["ep"]["layer"]["out"],
                              world4[2 * d + 1]["ep"]["layer"]["out"])


def test_ep_payload_under_tp_matches_the_model(spawned):
    """The bytes a rank sends in the EP exchanges equal
    ``modeled_ep_bytes``: a MoE layer's forward (three chain
    all-to-alls over its model column's DP group), the moe-ep decode
    cell's, and the smoke model's grad function's (the forward's, the
    remat'd recompute's and the two token exchanges' transposes); the
    same on every model column."""
    from repro_torch.parallel.tp import modeled_ep_bytes

    world4, _ = spawned
    cfg = dataclasses.replace(C.get_smoke_config(tc.EP_ARCH), moe_ep_dispatch=True)
    one = dataclasses.replace(cfg, num_layers=2)  # a dense layer, then one MoE layer
    rows = tc.SMOKE_TRAIN[3] // 2 * tc.SMOKE_TRAIN[2]
    with tc.compute_dtype(torch.float32):
        for r, out in enumerate(world4):
            d = r // 2
            got = out["ep"]
            assert got["layer"]["ep_bytes"] == modeled_ep_bytes(
                one, tc.B_EP // 2 * tc.S_EP, 2, d) > 0
            assert got["decode"]["ep_bytes"] == modeled_ep_bytes(cfg, tc.B_EP // 2, 2, d) > 0
            assert got["grad_ep_bytes"] == modeled_ep_bytes(cfg, rows, 2, d, train=True) > 0


def test_ep_decode_cell_under_tp_matches_jax(spawned, jax_tp):
    """``build_cell("deepseek-moe-16b", "decode_smoke", (2, 2),
    variant="moe-ep")`` run in f32 compute: each rank's greedy tokens
    equal JAX's serve step jitted with the cell's shardings on a
    ``(2, 2)`` mesh (its EP over ``data`` under GSPMD's ``model``), and
    the cache gathered over the model group by the decoded rule (within
    1e-2 of each leaf's scale)."""
    world4, _ = spawned
    ref = jax_tp["ep_decode"]
    n = tc.B_EP // 2
    for r, out in enumerate(world4):
        got = out["ep"]["decode"]
        rows = slice((r // 2) * n, (r // 2 + 1) * n)
        assert np.array_equal(got["tokens"], ref["tokens"][rows])
        for i, a in enumerate(got["cache"]):
            b = ref[f"cache{i}"][:, rows]
            assert a.shape == b.shape and _max_rel(a, b) < 1e-2, i


def test_ep_xla_step_under_tp_matches_its_torrent_step(spawned):
    """Two steps of the ``moe-ep`` smoke train cell on ``(2, 2)`` with
    ``collectives="xla"`` (the backend's all-reduce of each rank's grads)
    against the same cell's Torrent steps (the chain all-reduce): the
    same function of the same draws, so losses within 1e-5 and the
    gathered params within f32 rounding of sums in another order. (JAX's
    xla step never reaches EP, so it has no JAX counterpart.)"""
    world4, _ = spawned
    for out in world4:
        xla, torrent = out["smoke_cells"][tc.EP_XLA_CELL[0]], out["smoke_cells"][
            "deepseek-moe-16b/moe-ep"]
        assert np.allclose(xla["losses"], torrent["losses"], atol=1e-5, rtol=0)
        for a, b in zip(xla["params"], torrent["params"]):
            np.testing.assert_allclose(a, b, atol=XLA_ATOL, rtol=XLA_RTOL)


@pytest.mark.parametrize("coll", ["torrent", "xla"])
def test_ep_trainer_tp2_matches_stacked_ep_trainer(spawned, stacked_trainers, coll):
    """``Trainer(TrainConfig(tp=2))`` on the 4-rank world (``(2, 2)``)
    with a ``moe_ep_dispatch`` config, Torrent and xla, against the
    stacked ``Trainer`` at DP = 2 (TP = 1: the two ranks in one forward
    exchanging tokens) from the same seeded params, f32 compute: the
    losses of its 2 steps within 1e-3."""
    world4, _ = spawned
    want = stacked_trainers["ep"][coll]
    for out in world4:
        assert np.allclose(out["ep_trainers"][coll], want, atol=LOSS_TOL, rtol=0)


def test_meshes_in_the_process_form(spawned):
    """Under ``torch.distributed`` (4 ranks) ``make_elastic_mesh`` is a
    ``ProcessMesh`` of ``choose_mesh_shape``'s factors (``(2, 2)``,
    ``(1, 4)``, and ``(4, 1)`` for a TP of 3 that does not divide), each
    rank at its row-major coordinates; ``make_production_mesh`` refuses
    the 4-rank world, naming its size, single-pod (256) and multi-pod
    (512)."""
    world4, _ = spawned
    for r, out in enumerate(world4):
        got = out["mesh_forms"]
        for tp, (dp_, tp_) in ((2, (2, 2)), (4, (1, 4)), (3, (4, 1))):
            is_process, shape, coords = got[f"elastic_{tp}"]
            assert is_process and shape == {"data": dp_, "model": tp_}
            assert coords == {"data": r // tp_, "model": r % tp_}
        for multi, n in ((False, 256), (True, 512)):
            msg = got[f"production_{multi}"]
            assert msg is not None and str(n) in msg and "world has 4" in msg
