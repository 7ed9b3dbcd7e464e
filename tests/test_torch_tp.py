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

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
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
from repro.launch.steps import make_train_step
from repro.models import transformer as T
from repro.optim import adamw
from repro.parallel import sharding as shd

d = np.load({inputs!r})
cfg = C.get_smoke_config({arch!r})
params = T.model_init(jax.random.PRNGKey(0), cfg)
batch = {{k: d[k] for k in ("tokens", "labels")}}
opt_cfg = adamw.OptConfig(**{adamw!r})
out = {{}}
for shape in ((2, 2), (1, 4)):
    name = f"{{shape[0]}}x{{shape[1]}}"
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = shd.param_pspecs(jax.eval_shape(lambda: params), cfg, tp=shape[1])
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                       is_leaf=lambda x: isinstance(x, P))
    bsh = NamedSharding(mesh, P("data", None))
    p = jax.tree.map(jax.device_put, params, psh)
    b = {{k: jax.device_put(v, bsh) for k, v in batch.items()}}
    step = make_train_step(cfg, opt_cfg, collectives="torrent", mesh=mesh,
                           batch_specs={{k: P("data", None) for k in batch}}, loss_chunks=2)
    with jax.set_mesh(mesh):
        grads = jax.jit(jax.grad(lambda p: T.loss_fn(p, cfg, b, loss_chunks=2)[0]))(p)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{{name}}/grad{{i}}"] = np.asarray(g, np.float32)
        o = adamw.init(p)
        f = jax.jit(step)
        for s in range(2):
            p, o, m = f(p, o, b)
            out[f"{{name}}/loss{{s}}"] = np.asarray(m["loss"])
            out[f"{{name}}/norm{{s}}"] = np.asarray(m["grad_norm"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{{name}}/param{{i}}"] = np.asarray(x, np.float32)
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def jax_tp(run_multidevice, inputs, tmp_path_factory):
    """JAX's Torrent train step on (2, 2) and (1, 4) meshes: the whole
    batch's grads, two steps' losses and grad norms, the params after."""
    root = tmp_path_factory.mktemp("jax_tp")
    np.savez(root / "in.npz", **inputs[1])
    run_multidevice(_JAX_TP.format(inputs=str(root / "in.npz"), out=str(root / "out.npz"),
                                   arch=tc.ARCH, adamw=tc.LINEAR_ADAMW), devices=4)
    got = dict(np.load(root / "out.npz"))
    n = len(jax.tree.leaves(inputs[0]))
    ref = {}
    for name in ("2x2", "1x4"):
        ref[name] = {"grads": [got[f"{name}/grad{i}"] for i in range(n)],
                     "params": [got[f"{name}/param{i}"] for i in range(n)],
                     "losses": [float(got[f"{name}/loss{s}"]) for s in range(2)],
                     "norms": [float(got[f"{name}/norm{s}"]) for s in range(2)]}
    ref["1x2"] = ref["2x2"]
    return ref


def _rows(batch: dict, dp: int, i: int) -> dict:
    n = B // dp
    return {k: torch.from_numpy(v[i * n:(i + 1) * n]) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tp1(inputs):
    """The port at TP = 1 (stacked view): each DP rank's first-step
    grads (bf16 and f32 compute), and two steps at DP = 1 and 2."""
    params_np, batch = inputs
    cfg = C.get_smoke_config(tc.ARCH)
    grad_fn = make_grad_fn(cfg, loss_chunks=2)
    out = {}
    for dp in (1, 2):
        params = params_from_numpy(params_np, "cpu")
        rec = {"grads": [], "grads_f32": [], "loss0": []}
        for i in range(dp):
            g, m = grad_fn(params, _rows(batch, dp, i))
            rec["grads"].append([x.numpy() for x in leaves(g)])
            rec["loss0"].append(float(m["loss"]))
            with tc.compute_dtype(torch.float32):
                rec["grads_f32"].append([x.numpy() for x in leaves(grad_fn(params, _rows(
                    batch, dp, i))[0])])
        step = make_train_step(cfg, adamw.OptConfig(**tc.LINEAR_ADAMW), collectives="torrent",
                               mesh=make_host_mesh(data=dp), loss_chunks=2)
        opt = adamw.init(params)
        losses, norms = [], []
        for _ in range(2):
            params, opt, m = step(params, opt, _rows(batch, 1, 0))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        rec.update(losses=losses, norms=norms, params=[x.numpy() for x in leaves(params)])
        out[dp] = rec
    return out


@pytest.fixture(scope="module")
def stacked_trainers(inputs, tmp_path_factory):
    """The stacked ``Trainer`` (TP = 1) in the configs the TP = 2 one
    runs: exact with a failure at step 3, and int8 + EF (its checkpoint
    is restored at TP = 2)."""
    root = tmp_path_factory.mktemp("stacked_tr")
    out = {}
    for name, kw in tc.TRAINER_RUNS.items():
        tr = Trainer(TrainConfig(ckpt_dir=str(root / name), **tc.TRAINER, **kw),
                     device="cpu", params=inputs[0])
        with tc.compute_dtype(torch.float32 if name == "exact" else torch.bfloat16):
            res = tr.run()
        out[name] = {"losses": res["losses"], "restarts": res["restarts"],
                     "state": [x.detach().numpy().copy() for x in leaves(tr.state)],
                     "dir": str(root / name)}
    return out


@pytest.fixture(scope="module")
def world4(inputs):
    return tdist.spawn(tc.world4_rank, 4, device="cpu", timeout_s=300, args=inputs)


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
def world2(inputs, stacked_trainers, jax_ckpt, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp2"))
    out = tdist.spawn(tc.world2_rank, 2, device="cpu", timeout_s=300,
                      args=(*inputs, root, stacked_trainers["int8"]["dir"], jax_ckpt[0]))
    return out, root


def _ranks(world4, world2, mesh: str) -> list[dict]:
    """Every rank's train case on ``mesh``."""
    if mesh == "1x2":
        return [r["train"] for r in world2[0]]
    return [r["train"][mesh] for r in world4]


@pytest.fixture(scope="module")
def spawned(world4, world2):
    return world4, world2


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


@pytest.mark.parametrize("name", list(tc.LEFT_OUT) + ["heads", "moe_ep", "prefill"])
def test_left_out_families_raise_naming_their_item(spawned, name):
    """Under a live model axis, each family TP does not cover yet, a
    dense config whose heads the TP size does not divide, a MoE config
    with ``moe_ep_dispatch`` and a left-out family's serving (qwen2-vl's
    prefill; the covered families serve, ``tests/test_torch_tp_serve.py``)
    raise ``NotImplementedError`` naming ROADMAP item 9c and the entry
    there."""
    world4, (world2, _) = spawned
    word = {"heads": "attn_seq_shard", "moe_ep": "moe_ep_dispatch", "prefill": "M-RoPE"}
    entry = {"qwen2-vl-7b": 2, "whisper-tiny": 3, "heads": 2, "moe_ep": 4, "prefill": 2}
    for r in world2:
        msg = r["refusals"][name]
        assert msg is not None and "9c" in msg and f"entry {entry[name]}" in msg
        assert (tc.LEFT_OUT.get(name) or word[name]) in msg


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
