"""The port's core (schedulers, ChainProgram planner, cycle model,
four-phase chain tasks) against ``repro.core``.

The four stdlib modules are byte-identical copies (pinned here), so the
port plans and prices every transfer exactly as the JAX package does;
``MultiChainTask`` moves ``uint8`` tensors instead of numpy arrays and
must deliver the same bytes with integer-identical ledgers.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.core import chaintask as jct  # noqa: E402
from repro.core import program as jprg  # noqa: E402
from repro.core import scheduling as jsch  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.topology import MeshTopology as JMesh  # noqa: E402
from repro.parallel.collectives import MultiChainPlan as JPlan  # noqa: E402
from repro.runtime.elastic import scale_down_plan as j_scale_down  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import chaintask as tct  # noqa: E402
from repro_torch.core import program as tprg  # noqa: E402
from repro_torch.core import scheduling as tsch  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.topology import MeshTopology as TMesh  # noqa: E402
from repro_torch.parallel.collectives import MultiChainPlan as TPlan  # noqa: E402
from repro_torch.runtime.elastic import scale_down_plan as t_scale_down  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# (mesh x, mesh y, torus, source, destinations)
CASES = [
    (4, 4, False, 0, [3, 5, 6, 9, 10, 12, 15]),
    (4, 4, True, 5, [0, 1, 2, 7, 8, 11, 13, 14]),
    (8, 1, False, 0, list(range(1, 8))),
    (8, 8, False, 27, [0, 7, 9, 14, 20, 33, 40, 45, 56, 63, 62, 18]),
]


def _meshes(x, y, torus):
    return JMesh(x, y, torus=torus), TMesh(x, y, torus=torus)


@pytest.mark.parametrize(
    "module", ["topology", "scheduling", "program", "simulator", "chainwrite_ref"]
)
def test_stdlib_copies_are_byte_identical(module):
    src = (REPO / "src/repro/core" / f"{module}.py").read_bytes()
    dst = (REPO / "src/repro_torch/core" / f"{module}.py").read_bytes()
    assert src == dst, f"src/repro_torch/core/{module}.py drifted from repro.core"


def test_runtime_monitor_copy_is_byte_identical():
    src = (REPO / "src/repro/runtime/monitor.py").read_bytes()
    dst = (REPO / "src/repro_torch/runtime/monitor.py").read_bytes()
    assert src == dst, "src/repro_torch/runtime/monitor.py drifted from repro.runtime"


@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_configs_match(arch):
    assert TC.ARCHS == JC.ARCHS
    for getter in ("get_config", "get_smoke_config"):
        j = getattr(JC, getter)(arch)
        t = getattr(TC, getter)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert _groups(j) == _groups(t)


def _groups(cfg):
    return [
        ([dataclasses.asdict(s) for s in pattern], reps)
        for pattern, reps in cfg.layer_groups()
    ]


@pytest.mark.parametrize("x,y,torus,src,dests", CASES)
@pytest.mark.parametrize("num_chains", [None, 1, 2, 3])
def test_partition_and_reform_orders_match(x, y, torus, src, dests, num_chains):
    jt, tt = _meshes(x, y, torus)
    jp = jsch.partition_schedule(jt, dests, src, num_chains=num_chains)
    tp = tsch.partition_schedule(tt, dests, src, num_chains=num_chains)
    assert jp == tp
    chain = max(tp, key=len)
    for failed in ([chain[0]], chain[1:3], [chain[-1]]):
        assert jsch.reform_chain(jt, chain, failed, src) == tsch.reform_chain(
            tt, chain, failed, src
        )


@pytest.mark.parametrize("x,y,torus,src,dests", CASES)
@pytest.mark.parametrize("nbytes", [1, 4096, 3 << 20])
def test_broadcast_program_and_cycles_match(x, y, torus, src, dests, nbytes):
    jt, tt = _meshes(x, y, torus)
    chains = tuple(tuple(c) for c in tsch.partition_schedule(tt, dests, src))
    L = x * y
    jp = jprg.plan_broadcast(L, src, chains)
    tp = tprg.plan_broadcast(L, src, chains)
    assert repr(jp.steps) == repr(tp.steps)
    assert jprg.program_wire_bytes(jp, nbytes) == tprg.program_wire_bytes(tp, nbytes)
    assert jsim.program_latency(jt, src, jp, nbytes) == tsim.program_latency(
        tt, src, tp, nbytes
    )
    assert jsim.unicast_latency(jt, src, dests, nbytes) == tsim.unicast_latency(
        tt, src, dests, nbytes
    )
    assert jsim.multi_chain_latency(
        jt, src, chains, nbytes, detail=True
    ) == tsim.multi_chain_latency(tt, src, chains, nbytes, detail=True)


def _task_pair(x, y, torus, src, dests, payload, **kw):
    jt, tt = _meshes(x, y, torus)
    jtask = jct.MultiChainTask(jt, src, dests, payload, **kw)
    ttask = tct.MultiChainTask(tt, src, dests, torch.from_numpy(payload), **kw)
    return jtask, ttask


def _assert_same_run(jtask, ttask):
    jb, tb = jtask.run(), ttask.run()
    assert sorted(jb) == sorted(tb)
    for d in jb:
        assert tb[d].dtype == torch.uint8
        np.testing.assert_array_equal(tb[d].numpy(), jb[d])
    assert ttask.cycle_ledger == jtask.cycle_ledger
    assert ttask.per_chain_ledgers == jtask.per_chain_ledgers
    assert ttask.chains == jtask.chains
    assert ttask.reformed_chains == jtask.reformed_chains
    assert ttask.unicast_cycles() == jtask.unicast_cycles()
    assert ttask.predicted_cycles() == jtask.predicted_cycles()


@pytest.mark.parametrize("x,y,torus,src,dests", CASES)
@pytest.mark.parametrize("num_chains", [None, 2])
def test_multichain_task_ledgers_and_bytes_match(x, y, torus, src, dests, num_chains):
    payload = np.random.default_rng(len(dests)).integers(0, 256, 5000, dtype=np.uint8)
    jtask, ttask = _task_pair(x, y, torus, src, dests, payload, num_chains=num_chains)
    _assert_same_run(jtask, ttask)
    for d in dests:  # identity pattern: every member gets the payload
        np.testing.assert_array_equal(ttask.node_buffers[d].numpy(), payload)


@pytest.mark.parametrize("x,y,torus,src,dests", CASES)
def test_multichain_task_with_failures_matches(x, y, torus, src, dests):
    payload = np.random.default_rng(7).integers(0, 256, 777, dtype=np.uint8)
    jtask, ttask = _task_pair(x, y, torus, src, dests, payload, num_chains=2)
    chain = max(ttask.chains, key=len)
    for node in chain[1:3]:  # a concurrent failure set inside one chain
        jtask.inject_failure(node)
        ttask.inject_failure(node)
    with pytest.raises(ValueError):
        ttask.inject_failure(chain[1])
    _assert_same_run(jtask, ttask)
    assert set(ttask.node_buffers) == set(dests) - set(chain[1:3])
    assert "recovery" in ttask.cycle_ledger


def test_multichain_task_affine_pattern_matches():
    """A non-identity DSE pattern goes through the general gather."""
    payload = np.arange(4096, dtype=np.int64).astype(np.uint8)
    pattern = dict(base=3, bounds=(16, 8, 4), strides=(256, 1, 64))
    jt, tt = _meshes(4, 4, False)
    dests = [1, 2, 6, 10, 15]
    jtask = jct.MultiChainTask(jt, 0, dests, payload, num_chains=2,
                               pattern=jct.AffinePattern(**pattern))
    ttask = tct.MultiChainTask(tt, 0, dests, torch.from_numpy(payload), num_chains=2,
                               pattern=tct.AffinePattern(**pattern))
    assert not ttask.tasks[0].pattern.is_identity(payload.size)
    np.testing.assert_array_equal(
        tct.AffinePattern(**pattern).indices().numpy(),
        jct.AffinePattern(**pattern).indices(),
    )
    _assert_same_run(jtask, ttask)
    want = payload[jct.AffinePattern(**pattern).indices() % payload.size]
    np.testing.assert_array_equal(ttask.node_buffers[15].numpy(), want)


def test_chain_task_identity_buffers_are_copies():
    """The DATA phase gives every member its own buffer (a device copy),
    never a view of the payload."""
    payload = torch.arange(64, dtype=torch.uint8)
    task = tct.ChainTask(TMesh(4, 1), 0, [1, 2, 3], payload, order=[1, 2, 3])
    bufs = task.run()
    jtask = jct.ChainTask(JMesh(4, 1), 0, [1, 2, 3], payload.numpy(), order=[1, 2, 3])
    jtask.run()
    assert task.cycle_ledger == jtask.cycle_ledger
    ptrs = {b.data_ptr() for b in bufs.values()} | {payload.data_ptr()}
    assert len(ptrs) == 4


@pytest.mark.parametrize("old,new", [(4, 3), (6, 2), (5, 5)])
def test_multichain_plan_scale_down_matches(old, new):
    jt, tt = _meshes(max(2, old), 1, False)
    jp = JPlan(jt, 0, list(range(1, old)))
    tp = TPlan(tt, 0, list(range(1, old)))
    assert jp.chains == tp.chains
    assert j_scale_down(jp, old, new) == t_scale_down(tp, old, new)
    assert jp.chains == tp.chains and jp.failed == tp.failed
    assert jp.survivors == tp.survivors
    assert tp.reform(99) is False  # unknown node: plan untouched
    with pytest.raises(tsim.SourceFailedError):
        tp.reform(0)


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|ml_dtypes|repro)(?:[.\s]|$)")
# The byte-identical copy of chainwrite_ref keeps the original's optional
# probe for ml_dtypes' float types: ``import ml_dtypes`` inside a
# ``try`` that returns False on ImportError (the card's machine has no
# ml_dtypes). It imports nothing of JAX or the JAX package.
_ALLOWED = {("src/repro_torch/core/chainwrite_ref.py", "import ml_dtypes")}
# Modules of the training slice that the check must cover.
_TRAIN_SLICE = [
    "src/repro_torch/core/chainwrite.py",
    "src/repro_torch/core/chainwrite_ref.py",
    "src/repro_torch/runtime/compression.py",
    "src/repro_torch/runtime/failure.py",
    "src/repro_torch/runtime/monitor.py",
    "src/repro_torch/runtime/elastic.py",
    "src/repro_torch/runtime/spans.py",
    "src/repro_torch/parallel/collectives.py",
    "src/repro_torch/optim/adamw.py",
    "src/repro_torch/data/pipeline.py",
    "src/repro_torch/checkpoint/manager.py",
    "src/repro_torch/launch/mesh.py",
    "src/repro_torch/launch/steps.py",
    "src/repro_torch/launch/train.py",
    "src/repro_torch/models/transformer.py",
]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "src/repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    rel = {str(f.relative_to(REPO)) for f in files}
    assert set(_TRAIN_SLICE) <= rel
    offenders = [
        f"{f.relative_to(REPO)}:{i}: {line.strip()}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if _IMPORT.match(line)
        and (str(f.relative_to(REPO)), line.strip()) not in _ALLOWED
    ]
    assert offenders == []
    probe = (REPO / "src/repro_torch/core/chainwrite_ref.py").read_text()
    assert "    try:\n        import ml_dtypes\n" in probe
    assert "except (ImportError, ValueError):\n        return False" in probe
