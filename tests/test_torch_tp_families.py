"""Tensor parallelism for the MoE, MLA, Mamba-2, hybrid, vlm and audio
families in the process form — experts over ``model``, MLA by heads,
Mamba-2 by ``d_inner`` with a model-wide gated norm, qwen2-vl's M-RoPE
heads, whisper's encoder, cross-attention and GeLU FFNs — in the
Torrent train step and the ``Trainer``, against the port at TP = 1 and
JAX's step on a ``(data, model)`` mesh, on the CPU with gloo.

The smoke deepseek-moe-16b, deepseek-v2-lite-16b, mamba2-2.7b and
jamba-v0.1-52b (its first 5 layers: ``tests/_tp_family_cases.LAYERS``)
run on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)``. At TP = 4 a jamba rank
holds one of its 4 experts, half of one of its 2 Mamba groups and half
a KV head. Three edge configs run beside them: the rowwise MoE
dispatch, 6 experts (whole at TP = 4, as ``param_pspecs`` leaves them)
and a ``d_inner`` of 126 (whole at TP = 4, 9 heads a rank at TP = 2).
The smoke qwen2-vl-7b (embeddings at M-RoPE positions), whisper-tiny
(tokens and encoder frames) and whisper with 6 heads under JAX's
``opt-seq`` variant (``attn_seq_shard``: 1.5 heads a rank at TP = 4)
run on ``(1, 4)`` and ``(2, 2)`` (``_tp_family_cases.FIXED``), the
edge against JAX's opt-seq xla step (JAX's cell's).

What runs where, so that the file's wall time is that of its longest
part: a module fixture starts JAX's steps on ``(2, 2)`` and ``(1, 4)``
meshes in two ``run_multidevice`` subprocesses (the four archs' eight
steps one after another, the FIXED names' five), a 4-rank spawn (``(1, 4)``
and ``(2, 2)``) and a 2-rank spawn (``(1, 2)``, and each arch's
``Trainer`` at TP = 2) and two ``torchrun --tp 2`` runs, all at once;
the port's TP = 1 references run meanwhile. The ranks run
``tests/_tp_family_cases.py``.

Tolerances. First-step grads with both sides computing in f32 within
1e-5 of each leaf's max (the TP function is TP = 1's, up to summation
order). Two Torrent steps against JAX's on the same mesh: losses within
1e-3, params within atol = rtol = 2e-3 (the steps use a first AdamW
step linear in the grads, ``_tp_cases.LINEAR_ADAMW``), as
``tests/test_torch_tp.py`` holds the dense family, with both packages'
``COMPUTE_DTYPE`` set to f32: in bf16 a MoE's top-k routing flips near
ties wherever the two packages, or two TP sizes, round a partial sum
differently (the smoke deepseek-moe-16b at ``(1, 4)``, second step:
1.1e-3 from JAX, while ``(1, 2)`` is within 1e-3 of the same run). The
bf16 steps are what the replicated-leaf and payload checks read. The ``(1, 2)`` mesh
is held against JAX's ``(1, 4)`` run: the TP size does not change the
function, but the DP size does for a MoE (each DP rank's capacity
comes from its own tokens). The ``Trainer`` at TP = 2 against
the stacked one in f32 compute: losses within 1e-3, state within 2e-3.
Replicated leaves and checkpoints: bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402

import _tp_cases as tc  # noqa: E402
import _tp_family_cases as fc  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.launch.steps import VARIANTS, make_grad_fn  # noqa: E402
from repro_torch.launch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import gated_rmsnorm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.tp import modeled_tp_bytes  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
LOSS_TOL, PARAM_TOL, GRAD_F32_TOL = 1e-3, 2e-3, 1e-5
TORCHRUN_ARCHS = ("deepseek-v2-lite-16b", "jamba-v0.1-52b")  # MLA + MoE; Mamba + MoE + GQA

_JAX_STEPS = """
import dataclasses
from jax.sharding import NamedSharding
from repro import configs as C
from repro.launch.steps import make_train_step
from repro.models import transformer as T
from repro.optim import adamw
from repro.parallel import sharding as shd

from repro.models import layers as L

L.COMPUTE_DTYPE = jnp.float32
d = np.load({inputs!r})
opt_cfg = adamw.OptConfig(**{adamw!r})


def run(job):
    arch, shape, base, changes, coll = job
    cfg = dataclasses.replace(C.get_smoke_config(base), **changes)
    like = jax.eval_shape(lambda: T.model_init(jax.random.PRNGKey(0), cfg))
    flat, treedef = jax.tree.flatten(like)
    params = jax.tree.unflatten(treedef, [d[f"{{arch}}/p{{i}}"] for i in range(len(flat))])
    batch = {{k: d[f"{{arch}}/{{k}}"] for k in ("tokens", "labels", "embeds", "positions",
                                            "enc_frames") if f"{{arch}}/{{k}}" in d}}
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = shd.param_pspecs(like, cfg, tp=shape[1])
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                       is_leaf=lambda x: isinstance(x, P))
    bspecs = {{k: P(None, "data", None) if k == "positions" else
               P("data", *([None] * (v.ndim - 1))) for k, v in batch.items()}}
    p = jax.tree.map(jax.device_put, params, psh)
    b = {{k: jax.device_put(v, NamedSharding(mesh, bspecs[k])) for k, v in batch.items()}}
    step = make_train_step(cfg, opt_cfg, collectives=coll, mesh=mesh, batch_specs=bspecs,
                           loss_chunks=2)
    name = f"{{arch}}/{{shape[0]}}x{{shape[1]}}"
    out = {{}}
    with jax.set_mesh(mesh):
        o = adamw.init(p)
        f = jax.jit(step)
        for s in range(2):
            p, o, m = f(p, o, b)
            out[f"{{name}}/loss{{s}}"] = np.asarray(m["loss"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{{name}}/param{{i}}"] = np.asarray(x, np.float32)
    return out


# one job after another: with the eight compiles in concurrent threads this
# subprocess once ran past its 900 s timeout during a parallel test run
# (about a minute alone)
jobs = {jobs!r}
out = {{}}
for o in map(run, jobs):
    out.update(o)
np.savez({out!r}, **out)
"""


def _torchrun(arch: str, ckpt_dir: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke", "--arch", arch,
           "--steps", "3", "--batch", "4", "--seq", "16", "--collectives", "torrent", "--tp",
           "2", "--fail-at", "2", "--ckpt-every", "1", "--ckpt-dir", ckpt_dir]
    if arch in fc.LAYERS:
        cmd += ["--layers", str(fc.LAYERS[arch])]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)


# JAX's steps: every arch on (2, 2) and (1, 4), the opt-seq edge on (1, 4)
JAX_MESHES = {"whisper_6_heads_opt_seq": ((1, 4),)}
# the meshes the FIXED names run on (the 4-rank spawn's): JAX's
FIXED_MESHES = ("1x4", "2x2")
NAMES = list(fc.ARCHS) + list(fc.EDGES) + list(fc.FIXED)


def _on_meshes(names) -> list[tuple[str, str]]:
    """(mesh, name) of every name on every mesh, a FIXED name on
    ``FIXED_MESHES``."""
    return [(m, n) for n in names for m in MESHES if n not in fc.FIXED or m in FIXED_MESHES]


@pytest.fixture(scope="module")
def params_np():
    """Each arch's params, drawn by the port from seed 0, as numpy."""
    return {arch: fc.init_params(fc.config(arch)) for arch in fc.ARCHS + fc.FIXED}


def _tp1_grads(cfg, params, dp: int) -> list:
    """The port at TP = 1 in f32 compute: each DP rank's first-step
    grads and loss."""
    batch = fc.batch(cfg.vocab_size, cfg)
    out = []
    for i in range(dp):
        with tc.compute_dtype(torch.float32):
            g, m = make_grad_fn(cfg, loss_chunks=fc.LOSS_CHUNKS)(
                params, fc.rank_rows(batch, dp, i, "cpu"))
        out.append(([x.numpy() for x in leaves(g)], float(m["loss"])))
    return out


@pytest.fixture(scope="module")
def runs(run_multidevice, params_np, tmp_path_factory):
    """Everything that runs outside this process, started at once: JAX's
    steps, the two spawns and the ``torchrun`` runs; meanwhile the port's
    TP = 1 references (the f32 first-step grads of every arch and edge
    config at DP = 1 and 2, and the stacked ``Trainer`` of every arch).
    Returns their results."""
    root = tmp_path_factory.mktemp("tp_families")
    inputs, jobs = {}, []
    for arch in fc.ARCHS + fc.FIXED:
        cfg = fc.config(arch)
        inputs.update({f"{arch}/p{i}": x for i, x in enumerate(leaves(params_np[arch]))})
        inputs.update({f"{arch}/{k}": v for k, v in fc.batch(cfg.vocab_size, cfg).items()})
        if arch in fc.FIXED_EDGES:
            base, variant, changes = fc.FIXED_EDGES[arch]
            changes = {**VARIANTS[variant], **changes}
        else:
            base, changes = arch, {"num_layers": cfg.num_layers}
        coll = fc.JAX_COLLECTIVES.get(arch, "torrent")
        jobs += [(arch, shape, base, changes, coll) for shape in JAX_MESHES.get(arch, ((2, 2),
                                                                                       (1, 4)))]
    np.savez(root / "in.npz", **inputs)
    # two subprocesses at once, each running its jobs one after another:
    # the four families' and the FIXED names'
    parts = [[j for j in jobs if (j[0] in fc.FIXED) == fixed] for fixed in (False, True)]
    codes = [_JAX_STEPS.format(inputs=str(root / "in.npz"), out=str(root / f"out{i}.npz"),
                               jobs=part, adamw=tc.LINEAR_ADAMW) for i, part in enumerate(parts)]
    with ThreadPoolExecutor(7) as ex:
        jax_runs = [ex.submit(run_multidevice, code, devices=4, timeout=900) for code in codes]
        world4 = ex.submit(tdist.spawn, fc.world4_rank, 4, device="cpu", timeout_s=600,
                           args=(params_np,))
        world2 = ex.submit(tdist.spawn, fc.world2_rank, 2, device="cpu", timeout_s=600,
                           args=(params_np, str(root / "tp2")))
        torchruns = {arch: ex.submit(_torchrun, arch, str(root / f"torchrun_{arch}"))
                     for arch in TORCHRUN_ARCHS}

        tp1 = {}
        for name in NAMES:
            cfg = fc.edge_config(name) if name in fc.EDGES else fc.config(name)
            params = params_from_numpy(fc.init_params(cfg) if name in fc.EDGES
                                       else params_np[name], "cpu")
            tp1[name] = {dp: _tp1_grads(cfg, params, dp) for dp in (1, 2)}
        stacked = {}
        for arch in fc.ARCHS:
            tr = Trainer(TrainConfig(arch=arch, ckpt_dir=str(root / "stacked" / arch),
                                     layers=fc.LAYERS.get(arch), **fc.TRAINER),
                         device="cpu", params=params_np[arch])
            with tc.compute_dtype(torch.float32):
                res = tr.run()
            stacked[arch] = {"losses": res["losses"],
                             "state": [x.detach().numpy().copy() for x in leaves(tr.state)]}

        got = {}
        for i, run in enumerate(jax_runs):
            run.result()
            got.update(np.load(root / f"out{i}.npz"))
        jax_ref = {}
        for arch, shape, *_ in jobs:
            n = len(leaves(params_np[arch]))
            key = f"{arch}/{shape[0]}x{shape[1]}"
            jax_ref[key] = {"losses": [float(got[f"{key}/loss{s}"]) for s in range(2)],
                            "params": [got[f"{key}/param{i}"] for i in range(n)]}
        for arch in fc.ARCHS + fc.FIXED:  # (1, 2) against (1, 4): one function
            for mesh in MESHES:
                jax_ref.setdefault(f"{arch}/{mesh}", jax_ref[f"{arch}/1x4"])
        return types.SimpleNamespace(
            world4=world4.result(), world2=world2.result(), root=str(root), tp1=tp1,
            stacked=stacked, jax=jax_ref,
            torchrun={a: (f.result(), str(root / f"torchrun_{a}")) for a, f in torchruns.items()})


def _ranks(runs, mesh: str) -> list[dict]:
    """Every rank's cases on ``mesh``."""
    ranks = runs.world2 if mesh == "1x2" else runs.world4
    return [r["cases"][mesh] for r in ranks]


def _max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _jax_config(name: str):
    import dataclasses

    if name in fc.FIXED_EDGES:
        base, variant, changes = fc.FIXED_EDGES[name]
        return dataclasses.replace(JC.get_smoke_config(base), **VARIANTS[variant], **changes)
    if name in fc.ARCHS or name in fc.FIXED:
        cfg = JC.get_smoke_config(name)
        return dataclasses.replace(cfg, num_layers=fc.LAYERS.get(name, cfg.num_layers))
    arch, changes = fc.EDGES[name]
    return dataclasses.replace(JC.get_smoke_config(arch), **changes)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,name", _on_meshes(NAMES))
def test_rank_holds_the_shards_jax_param_pspecs_place(runs, mesh, name):
    """Each rank's params have the shapes JAX's ``param_pspecs(tp)``
    leaves on a device of the mesh: a stacked MoE leaf split along its
    expert dim (not the layer dim before it), an ``E`` or a ``d_inner``
    the TP size does not divide whole."""
    tp = MESHES[mesh][1]
    cfg = _jax_config(name)
    like = jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0), cfg))
    specs = jax.tree.leaves(jshd.param_pspecs(like, cfg, tp=tp),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = [tuple(s // (tp if e == "model" else 1) for s, e in
                  zip(x.shape, tuple(spec) + (None,) * (len(x.shape) - len(spec))))
            for x, spec in zip(jax.tree.leaves(like), specs)]
    for r in _ranks(runs, mesh):
        assert r[name]["shard_shapes"] == want


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,name", _on_meshes(NAMES))
def test_first_step_grads_match_tp1_in_f32(runs, mesh, name):
    """Each rank's grads of its DP rows in f32 compute, gathered, within
    1e-5 of each leaf's max of the port's at TP = 1 on the same rows,
    and the loss as close."""
    dp = MESHES[mesh][0]
    for r in _ranks(runs, mesh):
        got = r[name]
        want, loss = runs.tp1[name][dp][got["dp_index"]]
        assert abs(got["loss0_f32"] - loss) < GRAD_F32_TOL * abs(loss)
        assert len(got["grads_f32"]) == len(want)
        for a, b in zip(got["grads_f32"], want):
            assert _max_rel(a, b) < GRAD_F32_TOL


@pytest.mark.parametrize("mesh,arch", _on_meshes(fc.ARCHS + fc.FIXED))
def test_two_steps_match_jax(runs, mesh, arch):
    """Two Torrent train steps in f32 compute: losses within 1e-3 and
    updated params within 2e-3 of JAX's GSPMD step on its ``(data,
    model)`` mesh from the same params and batch."""
    ref = runs.jax[f"{arch}/{mesh}"]
    for r in _ranks(runs, mesh):
        got = r[arch]
        assert np.allclose(got["losses_f32"], ref["losses"], atol=LOSS_TOL, rtol=0)
        if "params_f32" in got:
            assert len(got["params_f32"]) == len(ref["params"])
            for a, b in zip(got["params_f32"], ref["params"]):
                np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)


@pytest.mark.parametrize("mesh,arch", _on_meshes(fc.ARCHS + fc.FIXED))
def test_replicated_leaves_are_bit_equal_across_tp_ranks(runs, mesh, arch):
    """After two steps, every leaf of the state (params and AdamW
    moments) that no spec splits — the router, ``w_dkv``, ``in_BC``,
    ``in_dt``, ``conv_BC_*``, ``dt_bias``, ``A_log``, ``D``, the norms —
    holds the same bits on every TP rank of a group, and so do the
    losses."""
    groups = {}
    for r in _ranks(runs, mesh):
        groups.setdefault(r[arch]["dp_index"], []).append(r[arch])
    for members in groups.values():
        first = members[0]
        assert len(members) == MESHES[mesh][1]
        assert not all(first["split"]) and any(first["split"])
        for other in members[1:]:
            for split, a, b in zip(first["split"], first["local"], other["local"]):
                if not split:
                    assert np.array_equal(a, b)
            assert other["losses"] == first["losses"]


@pytest.mark.parametrize("mesh,arch", _on_meshes(fc.ARCHS + fc.FIXED))
def test_tp_payload_bytes_match_their_model(runs, mesh, arch):
    """The payload bytes a rank hands the model group's collectives in
    one step equal ``modeled_tp_bytes``: the MoE's f32 combine and the
    grads of its split input and ``top_p``; MLA's ``wo`` and the grads
    of its ``wq`` input and ``c``/``k_rope``; Mamba-2's ``out_proj``,
    its norm's sum of squares, the grads of its ``in_z``/``in_x`` input,
    B/C, dt, ``A_log`` and ``D``; the remat'd recompute."""
    dp, tp = MESHES[mesh]
    cfg = fc.config(arch)
    want = modeled_tp_bytes(cfg, fc.B // dp * fc.S, tp,
                            enc_tokens=fc.B // dp * cfg.encoder_seq_len)
    for r in _ranks(runs, mesh):
        assert r[arch]["tp_bytes"] == want


# ---------------------------------------------------------------------------
# The gated norm and the head-cutting split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gated_norm_statistic_is_model_wide(runs, mesh):
    """``gated_rmsnorm`` over a model group, each rank holding its block
    of ``d_inner``, is the unsplit norm's block: output and the grads of
    ``x``, ``z`` and the scale, to f32 rounding."""
    ranks = runs.world2 if mesh == "1x2" else runs.world4
    x, z, scale, w = (torch.from_numpy(a) for a in fc.norm_inputs())
    x.requires_grad_(True)
    z.requires_grad_(True)
    scale.requires_grad_(True)
    y = gated_rmsnorm({"scale": scale}, x, z, 1e-5)
    (y * w).sum().backward()
    want = {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dz": z.grad.numpy()}
    tp = MESHES[mesh][1]
    k = fc.NORM_SHAPE[-1] // tp
    # the scale's grad: each rank's block of it
    for r in ranks:
        i = r["mesh"][mesh]["coords"]["model"] if mesh != "1x2" else r["mesh"]["coords"]["model"]
        got = r["norm"][mesh]
        for key, full in want.items():
            np.testing.assert_allclose(got[key], full[..., i * k:(i + 1) * k], atol=1e-6,
                                       rtol=1e-5)
        np.testing.assert_allclose(got["dscale"], scale.grad.numpy()[i * k:(i + 1) * k],
                                   atol=1e-6, rtol=1e-5)
    # a rank-local statistic would be a different function
    local = gated_rmsnorm({"scale": scale[:k]}, x[..., :k], z[..., :k], 1e-5)
    assert np.abs(local.detach().numpy() - want["y"][..., :k]).max() > 1e-2


@pytest.mark.parametrize("tp", [2, 4])
def test_split_that_cuts_a_head_raises(runs, tp):
    """mamba2 with heads of 64 (2 of them in a d_inner of 128): at TP = 2
    a rank holds one whole head and trains; at TP = 4 ``param_pspecs``
    would split a head, and the forward raises ``NotImplementedError``
    instead of running part of it."""
    msg = (runs.world4[0] if tp == 4 else runs.world2[0])["refusals"]["cut_head"]
    if tp == 2:
        assert msg is None
    else:
        assert msg is not None and "cuts a head" in msg


# ---------------------------------------------------------------------------
# The Trainer, checkpoints and torchrun
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", fc.ARCHS)
def test_trainer_tp2_matches_tp1(runs, arch):
    """``Trainer(TrainConfig(tp=2))`` in the process form against the
    stacked ``Trainer`` from the same params, four steps in f32 compute:
    losses within 1e-3 a step, the gathered state (params and AdamW
    moments) within 2e-3; both ranks hold the same."""
    ref = runs.stacked[arch]
    for r in runs.world2:
        got = r["trainer"][arch]
        assert np.allclose(got["losses"], ref["losses"], atol=LOSS_TOL, rtol=0)
        assert len(got["state"]) == len(ref["state"])
        for a, b in zip(got["state"], ref["state"]):
            np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=PARAM_TOL)
    a, b = runs.world2
    assert all(np.array_equal(x, y) for x, y in zip(a["trainer"][arch]["state"],
                                                    b["trainer"][arch]["state"]))


@pytest.mark.parametrize("arch", fc.ARCHS)
def test_tp2_checkpoint_restores_stacked_and_in_jax(runs, params_np, arch):
    """The TP = 2 Trainer's last checkpoint holds the logical leaves: the
    stacked form and the JAX package restore its gathered state bit for
    bit."""
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    from repro.optim import adamw as jadamw

    d = os.path.join(runs.root, "tp2", arch)
    want = runs.world2[0]["trainer"][arch]["state"]
    p = params_from_numpy(params_np[arch], "cpu")
    ckpt = CheckpointManager(d)
    assert ckpt.latest_step() == fc.TRAINER["steps"]
    got = ckpt.restore(ckpt.latest_step(), {"params": p, "opt": adamw.init(p)})
    ckpt.close()
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(leaves(got), want))
    cfg = _jax_config(arch)
    like = jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0), cfg))
    jck = JCkpt(d)
    jgot = jck.restore(jck.latest_step(), {"params": like, "opt": jax.eval_shape(jadamw.init,
                                                                                 like)})
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(jax.tree.leaves(jgot), want))


@pytest.mark.parametrize("arch", TORCHRUN_ARCHS)
def test_torchrun_tp2_restarts_from_its_checkpoint(runs, arch):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --tp 2``
    trains the smoke model on a ``(data=1, model=2)`` mesh through an
    injected failure and a restart from the checkpoint rank 0 wrote."""
    proc, ckpt_dir = runs.torchrun[arch]
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "done: 3 steps (1 restarts)" in proc.stdout + proc.stderr
    assert sorted(os.listdir(ckpt_dir))[-1] == "ckpt_000000003"


def test_specs_split_expert_dim_of_stacked_moe_leaves():
    """``param_pspecs`` of a stacked MoE leaf ``(reps, E, d, f)`` names
    ``model`` on the expert dim, and ``shard_tree`` cuts that dim."""
    cfg = fc.config("deepseek-moe-16b")
    params = params_from_numpy(fc.init_params(cfg), "cpu")
    specs = shd.param_pspecs(params, cfg, tp=2)
    leaf, spec = params["groups"][1][0]["ffn"]["wg"], specs["groups"][1][0]["ffn"]["wg"]
    assert tuple(spec) == (None, "model", None, None)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, coords={"data": 0, "model": 1})
    block = shd.shard_tree(leaf, spec, mesh)
    assert torch.equal(block, leaf[:, cfg.num_experts // 2:])
