"""The process form's training — one rank per process on
``torch.distributed`` — against JAX's ``Trainer`` and the stacked form,
on the CPU with gloo: the ``Trainer`` (Torrent exact and int8 + EF, and
``collectives="xla"``), checkpoints across the two forms, a microbatched
and an expert-parallel train step, the spans of a step, and ``torchrun``
itself. (``tests/test_torch_dist.py`` holds the executor, the meshes and
the grad reduction; the two files are split so that a parallel run can
spread them.)

One 4-rank spawn is shared by the module (``tests/_dist_cases.py``'s
``world4_rank``): it runs every case and keeps the results; the tests
read their own. AdamW's moments there are each rank's ZeRO-1 blocks
over ``data`` (``parallel.sharding.opt_pspecs``), as JAX's ``Trainer``
places them.

Tolerances. Trainer losses: within 5e-3 a step of JAX's 4-device
``Trainer`` (as ``tests/test_torch_train.py`` holds the stacked one).
Against the stacked ``Trainer``, whose ranks run in one process with
every CPU thread where each spawned rank has one (matmuls then sum in
another order), within 1e-5 a step at the exact wire (measured 4.8e-7)
and with ``collectives="xla"``; at the int8 wire within 2e-3 (measured
3e-4), since each process updates its block from its own reduced row
where the stacked form hands every rank row 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_cases as dc  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.collectives import ef_residual_init  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = "deepseek-moe-16b"


def _batch(B: int, S: int, vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}

# ---------------------------------------------------------------------------
# The train step, the Trainer and checkpoints
# ---------------------------------------------------------------------------

_JAX_TRAINER = """
import json
from repro.launch.train import TrainConfig, Trainer
base = {base!r}
out = {{}}
for name, kw in (("exact", {{}}), ("int8", {{"compress_grads": True}})):
    out[name] = Trainer(TrainConfig(ckpt_dir={root!r} + "/" + name, **base, **kw)).run()["losses"]
print("LOSSES", json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_trainer(run_multidevice, tmp_path_factory):
    """JAX's Trainer (torrent, 4 virtual devices), both wires, and its
    step-0 params (numpy) restored from its checkpoint."""
    root = tmp_path_factory.mktemp("jax_trainer")
    out = run_multidevice(_JAX_TRAINER.format(base=dc.TRAINER, root=str(root)), devices=4)
    losses = json.loads(out.split("LOSSES", 1)[1])
    like = TT.model_init(torch.Generator().manual_seed(1), TCfg.get_smoke_config("yi-6b"), "cpu")
    start = CheckpointManager(str(root / "exact")).restore(0, {"params": like}, device="cpu")
    return losses, map_tree(lambda t: t.numpy(), start["params"])


def _stacked_state(params_np, step: int = 5):
    """A stacked-form state at dp = 4 with a nonzero EF residual."""
    p = params_from_numpy(params_np, "cpu")
    opt = adamw.init(p)
    opt["step"] = torch.tensor(step, dtype=torch.int32)
    ef = map_tree(lambda t: torch.randn((4,) + tuple(t.shape),
                                        generator=torch.Generator().manual_seed(t.numel())),
                  p)
    return {"params": p, "opt": opt, "ef": ef}


@pytest.fixture(scope="module")
def moe_model():
    """The smoke deepseek-moe-16b model's params (numpy), from a seed."""
    p = TT.model_init(torch.Generator().manual_seed(3), TCfg.get_smoke_config(MOE), "cpu")
    return map_tree(lambda t: t.numpy(), p)


@pytest.fixture(scope="module")
def world4(jax_trainer, moe_model, tmp_path_factory):
    _, params = jax_trainer
    root = tmp_path_factory.mktemp("world4")
    ckpt = CheckpointManager(str(root / "stacked"))
    ckpt.save(5, _stacked_state(params), blocking=True)
    ckpt.close()
    out = tdist.spawn(dc.world4_rank, 4, device="cpu", timeout_s=300,
                      args=(params, str(root), _batch(8, 32, 256, 7), moe_model))
    return out, root


@pytest.mark.parametrize("name", ["exact", "int8"])
def test_process_trainer_matches_jax_trainer(jax_trainer, world4, name):
    """The process-form Trainer (4 ranks, torrent, the int8 run with EF)
    against JAX's Trainer on 4 virtual devices from the same params:
    losses within 5e-3 a step, the same on every rank, and each rank
    loading its own rows of every batch."""
    losses, _ = jax_trainer
    out, _ = world4
    got = out[0][name]["losses"]
    assert len(got) == len(losses[name]) == dc.TRAINER["steps"]
    assert max(abs(a - b) for a, b in zip(got, losses[name])) < 5e-3, (got, losses[name])
    assert all(o[name]["losses"] == got for o in out)
    assert [o[name]["rows"] for o in out] == [(0, 2), (2, 4), (4, 6), (6, 8)]


@pytest.mark.parametrize("name", ["exact", "int8"])
def test_process_trainer_matches_stacked_trainer(jax_trainer, world4, tmp_path, name):
    """The process form against the stacked Trainer (``dp=4``) from the
    same params: losses within 1e-5 a step at the exact wire and 2e-3 at
    the int8 wire (the module docstring says why they differ at all);
    the exact run's params on every rank equal to rank 0's."""
    _, params = jax_trainer
    out, _ = world4
    tr = Trainer(TrainConfig(dp=4, ckpt_dir=str(tmp_path), compress_grads=name == "int8",
                             **dc.TRAINER), device="cpu", params=params)
    want = tr.run()["losses"]
    got = out[0][name]["losses"]
    assert max(abs(a - b) for a, b in zip(got, want)) < (1e-5 if name == "exact" else 2e-3)
    if name == "exact":
        for o in out[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(o[name]["params"],
                                                            out[0][name]["params"]))


def test_process_checkpoint_restores_in_stacked_trainer(world4):
    """The int8 + EF process run's last checkpoint, restored by the
    stacked form (``dp=4``): rank 0's params and every rank's EF residual
    row, bit for bit."""
    out, root = world4
    params = TT.model_init(torch.Generator().manual_seed(1), TCfg.get_smoke_config("yi-6b"),
                           "cpu")  # the structure only
    like = {"params": params, "opt": adamw.init(params), "ef": ef_residual_init(params, 4)}
    ckpt = CheckpointManager(str(root / "proc_int8"))
    got = ckpt.restore(ckpt.latest_step(), like, device="cpu")
    ckpt.close()
    assert ckpt.latest_step() == dc.TRAINER["steps"] and int(got["opt"]["step"]) == 6
    for a, b in zip(leaves(got["params"]), out[0]["int8"]["params"]):
        assert np.array_equal(a.numpy(), b)
    for i, e in enumerate(leaves(got["ef"])):
        for r in range(4):
            assert np.array_equal(e[r].numpy(), out[r]["int8"]["ef"][i][0])
    assert any(float(e.abs().max()) > 0 for e in leaves(got["ef"]))


def test_stacked_checkpoint_restores_in_processes(jax_trainer, world4):
    """A stacked-form checkpoint (dp = 4, EF residual rows) restored by
    the process form: each rank gets its row and the shared params."""
    _, params = jax_trainer
    out, _ = world4
    want = _stacked_state(params)
    for r in range(4):
        got = out[r]["restored"]
        assert got["step"] == 5
        for a, b in zip(leaves(want["params"]), got["params"]):
            assert np.array_equal(a.numpy(), b)
        for a, b in zip(leaves(want["ef"]), got["ef"]):
            assert b.shape == (1,) + tuple(a.shape[1:]) and np.array_equal(a[r].numpy(), b[0])


def test_microbatched_process_step_matches_stacked(jax_trainer, world4):
    """``microbatches=2`` on a ``ProcessMesh`` (each rank accumulates its
    two microbatches, then one reduction) against the stacked step (a
    reduction per microbatch): the same update within f32 rounding of
    sums in another order (rtol 1e-5, atol 1e-6, as
    ``tests/test_torch_train.py`` holds its microbatched step), one
    AdamW step that ``eps = 1`` keeps linear in the grads."""
    _, params = jax_trainer
    out, _ = world4
    cfg = TCfg.get_smoke_config("yi-6b")
    p = params_from_numpy(params, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, 32, 256, 7).items()}
    step = make_train_step(cfg, adamw.OptConfig(**dc.LINEAR_ADAMW), collectives="torrent",
                           mesh=make_host_mesh(data=4), loss_chunks=2, microbatches=2)
    new_p, _, m = step(p, adamw.init(p), batch)
    assert abs(float(m["loss"]) - out[0]["microbatched"]["loss"]) < 1e-5
    for a, b in zip(leaves(new_p), out[0]["microbatched"]["params"]):
        torch.testing.assert_close(torch.from_numpy(b), a, rtol=1e-5, atol=1e-6)


def test_process_step_records_spans(world4):
    """A process-form step (Torrent and xla), and its expert-parallel
    step, record one ``fwd_bwd``, one ``reduce``, one ``optimizer`` and,
    inside it, one ``param_gather`` span each (ZeRO-1 over ``data``)."""
    out, _ = world4
    for o in out:
        assert o["spans"] == o["xla_spans"] == o["ep_step"]["spans"] == {
            "fwd_bwd": 1, "reduce": 1, "optimizer": 1, "param_gather": 1}


def test_process_xla_trainer_matches_stacked_xla_trainer(jax_trainer, world4, tmp_path):
    """``Trainer(TrainConfig(collectives="xla"))`` in the process form (4
    ranks, the backend's all-reduce, JAX's default) against the stacked
    ``Trainer`` (``dp=4``) from the same params: losses within 1e-5 a
    step (f32 rounding of the ranks' sum in another order), the same on
    every rank; params equal across the ranks (ZeRO-1's gather), each
    rank's moments a quarter of its params' leaves."""
    _, params = jax_trainer
    out, _ = world4
    tr = Trainer(TrainConfig(dp=4, ckpt_dir=str(tmp_path), **dict(dc.TRAINER, collectives="xla")),
                 device="cpu", params=params)
    want = tr.run()["losses"]
    got = out[0]["xla"]["losses"]
    assert len(got) == dc.TRAINER["steps"]
    assert max(abs(a - b) for a, b in zip(got, want)) < 1e-5
    assert all(o["xla"]["losses"] == got for o in out)
    for o in out[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(o["xla"]["params"],
                                                        out[0]["xla"]["params"]))
    whole = [tuple(x.shape) for x in leaves(tr.state["params"])]
    blocks = out[0]["xla"]["moment_shapes"]
    assert [4 * int(np.prod(b)) for b in blocks] == [int(np.prod(w)) for w in whole]


def test_ep_remat_recompute_keeps_the_process_mesh(world4):
    """The remat'd backward recomputes each layer group's forward, the
    process-form exchanges included, on the autograd engine's thread for
    a CUDA device, where the caller's ``set_mesh`` is not set: a backward
    run after the block has closed gives the grads of one inside it."""
    out, _ = world4
    assert all(o["ep_remat_equal"] for o in out)


def test_ep_train_step_matches_stacked_joint_step(moe_model, world4):
    """``moe_ep_dispatch`` inside the process-form train step (4 ranks,
    each MoE layer exchanging tokens over the processes, Torrent K = 2)
    against the stacked step's one joint forward over the 4 ranks: the
    loss within 1e-3 and each leaf's update within 5% of its largest
    element, cosine >= 0.999, the model-level bounds of bf16 grads
    computed on other batch shapes (measured: equal bit for bit); one
    AdamW step that ``eps = 1`` keeps linear in the grads."""
    out, _ = world4
    cfg = dataclasses.replace(TCfg.get_smoke_config(MOE), moe_ep_dispatch=True)
    p = params_from_numpy(moe_model, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, 32, 256, 7).items()}
    step = make_train_step(cfg, adamw.OptConfig(**dc.LINEAR_ADAMW), collectives="torrent",
                           mesh=make_host_mesh(data=4), loss_chunks=2, num_chains=2)
    new_p, _, m = step(p, adamw.init(p), batch)
    assert abs(float(m["loss"]) - out[0]["ep_step"]["loss"]) < 1e-3
    for p0, a, b in zip(leaves(moe_model), leaves(new_p), out[0]["ep_step"]["params"]):
        da, db = a.double().numpy() - p0, b.astype(np.float64) - p0
        assert np.abs(da - db).max() <= 5e-2 * np.abs(da).max()
        assert (da * db).sum() >= 0.999 * np.sqrt((da * da).sum() * (db * db).sum())




def test_torchrun_main_on_cpu(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --device
    cpu``: two gloo ranks train with int8 + EF through an injected
    failure and a restart from the checkpoint rank 0 wrote."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke", "--steps", "3",
         "--batch", "4", "--seq", "16", "--collectives", "torrent", "--compress-grads",
         "--fail-at", "2", "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "done: 3 steps (1 restarts)" in proc.stdout + proc.stderr
    assert sorted(os.listdir(tmp_path))[-1] == "ckpt_000000003"
