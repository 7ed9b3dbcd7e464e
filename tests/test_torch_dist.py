"""The process form — one rank per process on ``torch.distributed``
(``core.chainwrite_dist``, ``launch.mesh.ProcessMesh``, ``launch.dist``)
— against the stacked executor, ``chainwrite_ref``'s oracles and JAX's
``shard_map`` ranks, on the CPU with gloo.

The spawn is shared: a module fixture spawns the 8-rank world once (the
executor grid, the meshes and the grad reduction, flat and over a 2 x 4
``("pod", "data")`` mesh), runs every case and keeps the results; the
parametrised tests read their own case. The JAX reference runs once per
module (``run_multidevice``). The train step, the ``Trainer``,
checkpoints and ``torchrun`` are ``tests/test_torch_dist_train.py``'s.

Tolerances. The executor is bit-exact: every rank's result equals the
stacked executor's row and the numpy oracle's (``np.array_equal``), at
both wires. The reduced grads equal the stacked reduction of the same
per-rank grads bit for bit; against JAX's 8-device run they agree within
3e-3, as JAX's own test holds its reduce to a single device's grads
(bf16 models). Expert parallelism across processes (deepseek-moe-16b's smoke MoE layer,
bf16 tokens, capacity 8) is held as ``tests/test_torch_moe.py`` holds the
stacked form: outputs within 2e-2 of JAX's ``shard_map`` ranks, aux
within 1e-5 relative, grads within 2e-2 of each leaf's max.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import chainwrite_ref as ref  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

import _dist_cases as dc  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.core import chainwrite as cw  # noqa: E402
from repro_torch.core import chainwrite_dist as cwd  # noqa: E402
from repro_torch.core import program as prg  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel.collectives import make_stacked_reduce  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402

L = 8
MOE = "deepseek-moe-16b"
EXEC_CASES = dc.cases(L)
# held against JAX's own 8-device run as well
JAX_ALL_REDUCE = dict(kind="all_reduce", K=2, seed=4, algo="rs_ag", wire="int8", n=16,
                      name="jax-int8-rs_ag-k2")
RINGS = ("all_reduce", "chain_all_reduce", "all_to_all", "reduce_scatter", "all_gather")


def _batch(B: int, S: int, vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def reduce_inputs():
    """The tiny model's params (JAX's init) and an (8, 8) batch."""
    params = jax.device_get(JT.model_init(jax.random.PRNGKey(0), dc.tiny_config(JC)))
    return params, _batch(8, 8, 32, 5)


@pytest.fixture(scope="module")
def moe_inputs():
    """deepseek-moe-16b's smoke MoE layer (JAX's init) and 8 ranks' tokens."""
    params = jax.device_get(JM.moe_init(jax.random.PRNGKey(0), JC.get_smoke_config(MOE)))
    x = (np.random.default_rng(3).standard_normal((L, 4, 64)) * 0.5).astype(np.float32)
    return params, x


@pytest.fixture(scope="module")
def world8(reduce_inputs, moe_inputs):
    params, batch = reduce_inputs
    return tdist.spawn(dc.world8_rank, L, device="cpu", timeout_s=120,
                       args=(EXEC_CASES + [JAX_ALL_REDUCE], params, batch, *moe_inputs))


_JAX_REDUCE = """
import dataclasses
from jax.sharding import NamedSharding
from repro import configs as C
from repro.core import chainwrite as cw
from repro.models import transformer as T
from repro.parallel.collectives import ef_residual_init, torrent_grad_reduce

d = np.load({inputs!r})
cfg = dataclasses.replace(C.get_smoke_config("yi-6b"), num_layers=1, d_model=32,
                          num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=32, head_dim=16)
params = T.model_init(jax.random.PRNGKey(0), cfg)
batch = {{"tokens": jnp.asarray(d["tokens"]), "labels": jnp.asarray(d["labels"])}}

def grad_fn(params, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: T.loss_fn(p, cfg, batch, loss_chunks=1), has_aux=True)(params)
    return grads, metrics

auto = (jax.sharding.AxisType.Auto,)
out = {{}}
for name, (knobs, pods) in {variants!r}.items():
    if pods:
        mesh = jax.make_mesh((pods, 8 // pods, 1), ("pod", "data", "model"), axis_types=auto * 3)
        spec = P(("pod", "data"), None)
    else:
        mesh = jax.make_mesh((8, 1), ("data", "model"), axis_types=auto * 2)
        spec = P("data", None)
    wrapped = torrent_grad_reduce(grad_fn, mesh, {{k: spec for k in batch}}, scheduler="tsp",
                                  **knobs)
    batch_d = {{k: jax.device_put(v, NamedSharding(mesh, spec)) for k, v in batch.items()}}
    with jax.set_mesh(mesh):
        if knobs.get("error_feedback"):
            grads = jax.jit(wrapped)(params, batch_d, ef_residual_init(params, 8))[0]
        else:
            grads = jax.jit(wrapped)(params, batch_d)[0]
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"{{name}}/{{i}}"] = np.asarray(g, np.float32)
mesh = jax.make_mesh((8,), ("x",))
f = jax.shard_map(lambda v: cw.multi_chain_all_reduce(v[0], "x", {rings!r}, algo="rs_ag",
                                                      wire_dtype="int8")[None],
                  mesh=mesh, in_specs=P("x"), out_specs=P("x"))
out["all_reduce"] = np.asarray(jax.jit(f)(jnp.asarray(d["xs"])))

from repro.models import moe as M
mcfg = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), capacity_factor=8.0)
mp = M.moe_init(jax.random.PRNGKey(0), C.get_smoke_config("deepseek-moe-16b"))
mx = jnp.asarray(d["moe_x"]).astype(jnp.bfloat16)
mesh = jax.make_mesh((8,), ("data",), axis_types=auto)

def ep(**kw):
    return jax.shard_map(lambda p, xs: M.moe_apply_ep(p, xs, mcfg, "data", **kw), mesh=mesh,
                         in_specs=(P(), P("data")), out_specs=(P("data"), P()), check_vma=False)

for name, kw in (("k1", {{}}), ("k2", {{"num_chains": 2}}), ("int8", {{"wire_dtype": "int8"}})):
    o, a = jax.jit(ep(**kw))(mp, mx)
    out["ep_" + name], out["ep_" + name + "_aux"] = np.asarray(o.astype(jnp.float32)), np.asarray(a)

def loss(p):
    o, a = ep()(p, mx)
    return jnp.mean(o.astype(jnp.float32) ** 2) + a

for i, g in enumerate(jax.tree.leaves(jax.jit(jax.grad(loss))(mp))):
    out[f"ep_grad{{i}}"] = np.asarray(g)
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def jax8(run_multidevice, reduce_inputs, moe_inputs, tmp_path_factory):
    """JAX's torrent_grad_reduce in every variant on 8 virtual devices,
    its int8 rs_ag K = 2 all-reduce, and its ``shard_map``
    ``moe_apply_ep`` (outputs, aux, grads)."""
    root = tmp_path_factory.mktemp("jax8")
    _, batch = reduce_inputs
    np.savez(root / "in.npz", xs=dc.global_input(JAX_ALL_REDUCE, L), moe_x=moe_inputs[1],
             **batch)
    run_multidevice(_JAX_REDUCE.format(
        inputs=str(root / "in.npz"), out=str(root / "out.npz"),
        variants={k: v for k, v in dc.REDUCE_VARIANTS.items()},
        rings=dc.rings(L, 2, 4)), devices=8)
    return dict(np.load(root / "out.npz"))


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def _oracle(c: dict, xs: np.ndarray) -> np.ndarray:
    k = c["kind"]
    if k == "all_reduce":
        return ref.multi_all_reduce_ref(xs, dc.rings(L, c["K"], c["seed"]), c["algo"], c["wire"])
    if k == "chain_all_reduce":
        return ref.multi_all_reduce_ref(xs, (dc._order(L, c["n"]),), wire_dtype=c["wire"])
    if k == "all_to_all":
        return ref.multi_all_to_all_ref(xs, dc.rings(L, c["K"], c["seed"]), c["wire"])
    if k == "reduce_scatter":
        return ref.multi_reduce_scatter_ref(xs, dc.rings(L, c["K"], c["seed"]))
    if k == "all_gather":
        return ref.multi_all_gather_ref(xs, dc.rings(L, c["K"], c["seed"]), c["tiled"])
    if k == "broadcast":
        return ref.multi_broadcast_ref(xs, c["head"], c["chains"])
    return ref.degraded_multi_broadcast_ref(xs, 0, dc.CHAINS[1][1], c["failed"])


def _members(c: dict) -> int:
    """Destinations of a broadcast case (after the failed are dropped)."""
    if c["kind"] == "broadcast":
        return sum(len(ch) for ch in c["chains"])
    return sum(len(ch) for ch in cw.degraded_chains(dc.CHAINS[1][1], c["failed"]))


@pytest.mark.parametrize("case", EXEC_CASES, ids=[c["name"] for c in EXEC_CASES])
def test_rank_equals_stacked_row_and_oracle(world8, case):
    """Every rank's result equals the stacked executor's row and the
    oracle's bit for bit. Each rank's byte count equals its model; on a
    ring that is ``program_wire_bytes``, on a broadcast the ranks' sum is
    (members - 1) x payload: each byte crosses each link once, whatever
    the frame count."""
    xs = dc.global_input(case, L)
    want = dc.run_stacked(case, torch.from_numpy(xs)).numpy()
    oracle = _oracle(case, xs)
    got = [world8[r]["executor"][case["name"]] for r in range(L)]
    for r, (row, sent, model, hlo) in enumerate(got):
        assert row.dtype == want.dtype and row.shape == want.shape[1:]
        assert np.array_equal(row, want[r]) and np.array_equal(row, oracle[r]), r
        assert sent == model
    if case["kind"] in RINGS:
        assert all(sent == hlo for _, sent, _, hlo in got)
    else:
        assert sum(sent for _, sent, _, _ in got) == _members(case) * xs[0].nbytes


def test_int8_all_reduce_equals_jax_8_device_run(world8, jax8):
    """int8 rs_ag K = 2 over 8 processes equals JAX's ``shard_map``
    executor on 8 virtual devices bit for bit, rank by rank."""
    name = JAX_ALL_REDUCE["name"]
    want = jax8["all_reduce"]
    for r in range(L):
        row = world8[r]["executor"][name][0]
        assert np.array_equal(row, want[r])


@pytest.mark.parametrize("planner", ["all_reduce", "all_gather", "reduce_scatter",
                                     "all_to_all", "broadcast"])
@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("frames", [1, 2, 3, 6])
def test_sent_wire_bytes_model(planner, K, frames):
    """The process form's byte model against the IR's: a ring rank sends
    ``program_wire_bytes``; a broadcast's ranks send (members - 1) x
    payload in all, the head one payload a chain, whatever the frame
    count (``pipelined_wire_bytes`` prices the HLO instead: one permute
    a step for the chains' fused edges, plus the scan's idle slots)."""
    rings = dc.rings(L, K, 3)
    size = 4 * 12 * 6
    if planner == "broadcast":
        chains = tuple(c for c in (rings[0][1:],) + rings[1:] if c)
        prog = prg.plan_broadcast(L, rings[0][0], chains)
        per_rank = [cwd.sent_wire_bytes(prog, size, frames, r) for r in range(L)]
        assert sum(per_rank) == cwd.sent_wire_bytes(prog, size, frames) == (L - 1) * size
        assert per_rank[rings[0][0]] == len(chains) * size
    else:
        for wire in ((None, "int8") if planner in ("all_reduce", "all_to_all") else (None,)):
            prog = getattr(prg, f"plan_{planner}")(L, rings, **(
                {"wire_dtype": wire} if wire else {}))
            for r in range(L):
                assert cwd.sent_wire_bytes(prog, size, 1, r) == prg.program_wire_bytes(prog, size)


def test_process_mesh_groups(world8):
    """The 2 x 4 ``("pod", "data")`` mesh: each rank's coordinates, its
    within-pod, across-pod and whole groups (group rank = the linear
    index over the axes); and a ``(pod=2, data=2, model=2)`` mesh, a
    ``(data=2, model=2)`` mesh in each pod: its ``model`` groups are
    consecutive ranks (group rank = the model coordinate), its ``data``
    groups join the ranks of one model coordinate."""
    for r in range(L):
        m = world8[r]["mesh"]
        assert m["coords"] == {"pod": r // 4, "data": r % 4, "model": 0}
        assert m["shape"] == {"pod": 2, "data": 4, "model": 1}
        assert m["data_group"] == (r % 4, 4) and m["pod_group"] == (r // 4, 2)
        assert m["dp_group"] == (r, 8)
        tp = m["tp"]
        assert tp["coords"] == {"pod": r // 4, "data": (r // 2) % 2, "model": r % 2}
        assert tp["model_group"] == (r % 2, 2) and tp["data_group"] == ((r // 2) % 2, 2)
        assert tp["dp_index"] == r // 2


def test_multichain_plan_broadcast_over_a_group(world8):
    """``MultiChainPlan.broadcast(group=)``, pipelined, then with every
    destination failed (only the head keeps its payload)."""
    from repro.core.topology import MeshTopology as JMesh
    from repro.parallel.collectives import MultiChainPlan as JPlan

    x = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    jp = JPlan(JMesh(2, 4), 0, [1, 2, 5, 6, 7], num_chains=2)
    want = ref.multi_broadcast_ref(x, 0, jp.chains)
    alone = np.zeros_like(x)
    alone[0] = x[0]
    for r in range(L):
        full, degraded = world8[r]["plan"]
        assert np.array_equal(full, want[r]) and np.array_equal(degraded, alone[r])


# ---------------------------------------------------------------------------
# The grad reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(dc.REDUCE_VARIANTS))
def test_torrent_grad_reduce_matches_jax_and_stacked(world8, jax8, name):
    """``torrent_grad_reduce`` on a ``ProcessMesh``: rank 0's grads within
    3e-3 of JAX's 8-device run; bit for bit the stacked reduction's of
    the same per-rank grads (and, under EF, each rank's residual equal to
    the stacked residual's row, over two steps); at the exact rs_ag wire
    every rank holds the same grads (the rotation's ranks fold the K
    rings' partial sums in their own orders); each rank's wire bytes
    equal the model and ``program_wire_bytes``; the metrics are the same
    on every rank."""
    knobs, pods = dc.REDUCE_VARIANTS[name]
    recs = [world8[r]["reduce"][name] for r in range(L)]
    n = len(recs[0]["grads"])
    for i in range(n):
        np.testing.assert_allclose(recs[0]["grads"][i], jax8[f"{name}/{i}"], atol=3e-3, rtol=3e-3)
    mesh = make_mesh((pods, L // pods, 1), ("pod", "data", "model")) if pods else \
        make_host_mesh(data=L)
    reduce = make_stacked_reduce(mesh, scheduler="tsp", **knobs)

    def stacked():
        return [torch.from_numpy(np.stack([world8[r]["raw"][i] for r in range(L)]))
                for i in range(n)]

    if knobs.get("error_feedback"):
        residual = [torch.zeros_like(s) for s in stacked()]
        for step in ("", "2"):
            out = reduce(stacked(), residual)
            for i in range(n):
                assert np.array_equal(out[i].numpy(), recs[0]["grads" + step][i])
                for r in range(L):
                    assert np.array_equal(residual[i][r].numpy(),
                                          recs[r]["residual" + step][i][0])
    else:
        out = reduce(stacked())
        for i in range(n):
            assert np.array_equal(out[i].numpy(), recs[0]["grads"][i])
            if knobs.get("algo", "rs_ag") == "rs_ag":
                assert all(np.array_equal(rec["grads"][i], recs[0]["grads"][i]) for rec in recs)
    for rec in recs:
        sent, model, hlo = rec["bytes"]
        assert sent == model == hlo > 0
        assert rec["loss"] == recs[0]["loss"]


# ---------------------------------------------------------------------------
# Expert parallelism across processes
# ---------------------------------------------------------------------------


def _moe_cfg(**kw):
    return dataclasses.replace(TCfg.get_smoke_config(MOE), capacity_factor=8.0, **kw)


@pytest.mark.parametrize("name", ["k1", "k2", "int8"])
def test_ep_process_form_matches_jax_and_stacked(world8, jax8, moe_inputs, name):
    """``moe_apply_ep`` over a group, one rank per process: each rank's
    output within 2e-2 of JAX's ``shard_map`` rank and equal to the
    stacked form's row bit for bit, the aux (averaged over the ranks by
    an all-reduce) within 1e-5; K = 1 and K = 2 equal bit for bit; the
    ``moe_ep_dispatch`` route under a ``ProcessMesh`` equal to the direct
    call."""
    params, x = moe_inputs
    tp = params_from_numpy(params, "cpu")
    kw = {"k2": {"num_chains": 2}, "int8": {"wire_dtype": "int8"}}.get(name, {})
    so, sa = TM.moe_apply_ep(tp, torch.from_numpy(x).to(torch.bfloat16)[:, None], _moe_cfg(),
                             **kw)
    for r in range(L):
        o, a = world8[r]["ep"][name]
        np.testing.assert_allclose(o, jax8["ep_" + name][r:r + 1], atol=2e-2, rtol=2e-2)
        assert np.array_equal(o, so[r].float().numpy())
        assert abs(a - float(jax8["ep_" + name + "_aux"])) <= 1e-5 * abs(a)
        assert abs(a - float(sa)) <= 1e-5 * abs(a)
        if name == "k2":
            assert np.array_equal(o, world8[r]["ep"]["k1"][0])
        if name == "k1":
            assert np.array_equal(world8[r]["ep"]["auto"][0], o)


def test_ep_process_grads_match_jax_and_stacked(world8, jax8, moe_inputs):
    """The ranks' grads of their shares of JAX's loss, summed, against
    JAX's grads through its ``shard_map`` EP and the stacked form's:
    within 2e-2 of each leaf's max (the backward runs the transposed
    exchanges and the all-reduce of the aux statistics)."""
    params, x = moe_inputs
    ps = map_tree(lambda t: t.detach().requires_grad_(True), params_from_numpy(params, "cpu"))
    o, a = TM.moe_apply_ep(ps, torch.from_numpy(x).to(torch.bfloat16)[:, None], _moe_cfg())
    stacked = torch.autograd.grad((o.float() ** 2).mean() + a, leaves(ps))
    for i, sg in enumerate(stacked):
        got = sum(world8[r]["ep"]["grads"][i] for r in range(L))
        want = jax8[f"ep_grad{i}"]
        span = np.abs(want).max()
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2e-2 * span, i
        assert np.abs(got - sg.numpy()).max() <= 2e-2 * span, i


# ---------------------------------------------------------------------------
# Launching, and what fails
# ---------------------------------------------------------------------------


def test_mismatched_program_raises_within_the_timeout():
    """A rank waiting for a frame that no rank sends fails the spawn in
    seconds, by the process group's timeout or the join's."""
    t0 = time.perf_counter()
    with pytest.raises((TimeoutError, torch.multiprocessing.ProcessRaisedException)):
        tdist.spawn(dc.stalled_rank, 2, device="cpu", timeout_s=10)
    assert time.perf_counter() - t0 < 60


def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="on purpose"):
        tdist.spawn(dc.failing_rank, 2, device="cpu", timeout_s=60)


def test_spawn_deadline_runs_from_the_join():
    """A spawn's ``timeout_s`` runs from the moment every rank has joined
    the process group: a world whose ranks take longer than it to start
    (each imports torch and this module's cases, seconds alone and a
    minute and more on a loaded host, 3-5 s on an idle 8-core one) still returns
    each rank's result."""
    assert tdist.spawn(dc.rank_of, 2, device="cpu", timeout_s=2) == [0, 1]


def test_spawn_and_init_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.rank_device("cuda", 0)


def test_spawn_and_init_default_to_the_card(monkeypatch):
    """Left without a device, ``spawn`` and ``init_from_env`` ask for the
    card: without one they raise before any process starts or any group
    is joined."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.spawn(dc.failing_rank, 2)
    assert time.perf_counter() - t0 < 5
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_from_env()
    assert not torch.distributed.is_initialized()
