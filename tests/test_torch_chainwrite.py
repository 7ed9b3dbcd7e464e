"""The port's ChainProgram executor (``repro_torch.core.chainwrite``)
against the numpy program interpreter and oracles of
``repro.core.chainwrite_ref``, bit for bit (``torch.equal`` /
``np.array_equal``, no tolerance): every planner, K in {1, 2, 4}, both
all-reduce algos, the exact and the int8 wire, scrambled rings,
frame-pipelined and degraded broadcasts, and the non-divisible pad path
of the all-reduce (held against ``multi_all_reduce_ref`` and
``all_reduce_ref``; the JAX test of that path crashes XLA:CPU). The
executor's wire-byte counter must equal ``program_wire_bytes``. One
int8 rs_ag K=2 all-reduce is also held against JAX's own 8-device run.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import chainwrite_ref as ref  # noqa: E402
from repro.core import program as jprg  # noqa: E402
from repro.parallel.collectives import MultiChainPlan as JPlan  # noqa: E402
from repro.core.topology import MeshTopology as JMesh  # noqa: E402

from repro_torch.core import chainwrite as cw  # noqa: E402
from repro_torch.core import program as prg  # noqa: E402
from repro_torch.core.topology import MeshTopology  # noqa: E402
from repro_torch.parallel.collectives import MultiChainPlan  # noqa: E402

L = 8


def _rings(K: int, seed: int) -> tuple[tuple[int, ...], ...]:
    """K disjoint equal rings over a scrambled permutation of the axis
    (seed 0: the canonical contiguous split)."""
    perm = np.arange(L) if seed == 0 else np.random.default_rng(seed).permutation(L)
    S = L // K
    return tuple(tuple(int(d) for d in perm[i * S:(i + 1) * S]) for i in range(K))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _check(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.from_numpy(want[:0].copy()).dtype
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def _counts_match() -> None:
    assert cw.wire_counter.steps > 0 or cw.wire_counter.bytes == 0
    assert cw.wire_counter.bytes == cw.wire_counter.modeled_bytes()


GRID = [(K, seed) for K in (1, 2, 4) for seed in (0, 1, 2)]


@pytest.mark.parametrize("K,seed", GRID)
@pytest.mark.parametrize("algo", ["rs_ag", "rotation"])
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("n", [24, 13, 1])
def test_all_reduce_matches_oracle(K, seed, algo, wire, n):
    """n=13 and n=1 take the zero-pad path (not divisible by the
    program's shard count)."""
    rings = _rings(K, seed)
    xs = np.random.default_rng(n + K).standard_normal((L, n, 3)).astype(np.float32)
    cw.wire_counter.reset()
    got = cw.multi_chain_all_reduce(_t(xs), rings, algo=algo, wire_dtype=wire)
    _check(got, ref.multi_all_reduce_ref(xs, rings, algo, wire))
    _counts_match()
    prog = prg.plan_all_reduce(L, rings, algo, wire_dtype=wire)
    S = prog.addr_shards
    padded = -(-n // S) * S * 3 * 4
    assert cw.wire_counter.bytes == prg.program_wire_bytes(prog, padded)


@pytest.mark.parametrize("n", [5, 13, 30])
@pytest.mark.parametrize("wire", [None, "int8"])
def test_chain_all_reduce_pad_path(n, wire):
    """The single-ring pad path against the schedule oracle bit for bit
    and, on integer-valued payloads (exact sums in any order), against
    the semantic oracle ``all_reduce_ref``."""
    rng = np.random.default_rng(n)
    order = tuple(int(d) for d in rng.permutation(L))
    xs = rng.standard_normal((L, n)).astype(np.float32)
    _check(cw.chain_all_reduce(_t(xs), order, wire_dtype=wire),
           ref.multi_all_reduce_ref(xs, (order,), wire_dtype=wire))
    if wire is None:
        ints = rng.integers(-50, 50, (L, n)).astype(np.float32)
        _check(cw.chain_all_reduce(_t(ints), order), ref.all_reduce_ref(ints))


@pytest.mark.parametrize("K,seed", GRID)
@pytest.mark.parametrize("wire", [None, "int8"])
def test_all_to_all_matches_oracle(K, seed, wire):
    rings = _rings(K, seed)
    xs = np.random.default_rng(K * 10 + seed).standard_normal((L, L, 5)).astype(np.float32)
    cw.wire_counter.reset()
    got = cw.multi_chain_all_to_all(_t(xs), rings, wire_dtype=wire)
    _check(got, ref.multi_all_to_all_ref(xs, rings, wire))
    _counts_match()
    if wire is None:
        _check(got, ref.all_to_all_ref(xs))
    if K == 1:
        _check(cw.chain_all_to_all(_t(xs), rings[0], wire_dtype=wire), got.numpy())


@pytest.mark.parametrize("K,seed", GRID)
def test_reduce_scatter_matches_oracle(K, seed):
    rings = _rings(K, seed)
    xs = np.random.default_rng(K + seed).standard_normal((L, L, 6)).astype(np.float32)
    cw.wire_counter.reset()
    got = cw.multi_chain_reduce_scatter(_t(xs), rings)
    _check(got, ref.multi_reduce_scatter_ref(xs, rings))
    _counts_match()
    if K == 1:
        _check(cw.chain_reduce_scatter(_t(xs), rings[0]), got.numpy())


@pytest.mark.parametrize("K,seed", GRID)
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
def test_all_gather_matches_oracle(K, seed, tiled, dtype):
    rings = _rings(K, seed)
    xs = (np.random.default_rng(seed).standard_normal((L, 4, 3)) * 100).astype(dtype)
    cw.wire_counter.reset()
    got = cw.multi_chain_all_gather(_t(xs), rings, tiled=tiled)
    _check(got, ref.multi_all_gather_ref(xs, rings, tiled))
    _check(got, ref.all_gather_ref(xs, tiled))
    _counts_match()


CHAINS = [
    (0, [(1, 2, 3, 4, 5, 6, 7)]),
    (0, [(1, 2, 3), (5, 4), (7,)]),
    (3, [(2, 1), (4, 5, 6, 7, 0)]),
    (5, [(0,), (1,), (2,), (7, 6)]),
]


@pytest.mark.parametrize("case", range(len(CHAINS)))
@pytest.mark.parametrize("frames", [1, 2, 3, 4, 6])
def test_broadcast_matches_oracle(case, frames):
    head, chains = CHAINS[case]
    xs = np.random.default_rng(case).standard_normal((L, 12, 2)).astype(np.float32)
    cw.wire_counter.reset()
    got = cw.multi_chain_broadcast(_t(xs), head, chains, num_frames=frames)
    _check(got, ref.multi_broadcast_ref(xs, head, chains))
    _counts_match()
    prog = prg.plan_broadcast(L, head, tuple(tuple(c) for c in chains))
    assert cw.wire_counter.bytes == prg.pipelined_wire_bytes(prog, 12 * 2 * 4, frames)
    if len(chains) == 1:
        _check(cw.chain_broadcast(_t(xs), (head,) + chains[0], num_frames=frames),
               ref.broadcast_ref(xs, (head,) + chains[0]))


@pytest.mark.parametrize("failed", [2, (2, 4), (1, 2, 3), 7, (4, 5, 7)])
@pytest.mark.parametrize("frames", [1, 3])
def test_degraded_broadcast_matches_oracle(failed, frames):
    head, chains = 0, [(1, 2, 3), (5, 4), (7,)]
    xs = np.random.default_rng(1).standard_normal((L, 6)).astype(np.float32)
    got = cw.degraded_multi_chain_broadcast(_t(xs), head, chains, failed, num_frames=frames)
    _check(got, ref.degraded_multi_broadcast_ref(xs, head, chains, failed))
    assert cw.degraded_chains(chains, failed) == [
        tuple(d for d in c if d not in np.atleast_1d(failed)) for c in chains
        if any(d not in np.atleast_1d(failed) for d in c)]


def test_degraded_broadcast_validation():
    x = torch.zeros((L, 4))
    with pytest.raises(ValueError, match="head"):
        cw.degraded_multi_chain_broadcast(x, 0, [(1, 2)], 0)
    with pytest.raises(ValueError, match="in no chain"):
        cw.degraded_multi_chain_broadcast(x, 0, [(1, 2)], 5)
    with pytest.raises(ValueError, match="empty"):
        cw.multi_chain_broadcast(x, 0, [])


@pytest.mark.parametrize("planner", ["broadcast", "all_gather", "reduce_scatter",
                                     "all_reduce", "all_to_all"])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_interpret_program_matches_numpy_interpreter(planner, K):
    """The raw interpreter on pre-blocked shards, program by program,
    against ``chainwrite_ref.interpret_program``."""
    rings = _rings(K, 3)
    if planner == "broadcast":
        prog = prg.plan_broadcast(L, rings[0][0], tuple(
            c for c in (rings[0][1:],) + rings[1:] if c))
    else:
        prog = getattr(prg, f"plan_{planner}")(L, rings)
    shards = np.random.default_rng(K).standard_normal(
        (L, prog.addr_shards, 3, 2)).astype(np.float32)
    jprog = (jprg.plan_broadcast(L, rings[0][0], tuple(
        c for c in (rings[0][1:],) + rings[1:] if c)) if planner == "broadcast"
        else getattr(jprg, f"plan_{planner}")(L, rings))
    _check(cw.interpret_program(_t(shards), prog), ref.interpret_program(shards, jprog))


def test_execute_program_validation():
    prog = prg.plan_all_reduce(L, _rings(2, 0), wire_dtype="int8")
    with pytest.raises(ValueError, match="rows"):
        cw.execute_program(torch.zeros((4, 8)), prog)
    with pytest.raises(ValueError, match="floating"):
        cw.execute_program(torch.zeros((L, 8), dtype=torch.int32), prog)
    with pytest.raises(ValueError, match="leading dim"):
        cw.execute_program(torch.zeros((L, 3, 2)), prg.plan_all_to_all(L, _rings(1, 0)))
    with pytest.raises(ValueError, match="permutation"):
        cw.chain_all_reduce(torch.zeros((L, 4)), (0, 1, 2))
    with pytest.raises(ValueError, match="algo"):
        cw.multi_chain_all_reduce(torch.zeros((L, 4)), _rings(2, 0), algo="tree")


def test_xla_broadcast_is_a_row_broadcast():
    xs = np.random.default_rng(0).standard_normal((L, 5)).astype(np.float32)
    got = cw.xla_broadcast(_t(xs), root=3)
    _check(got, np.stack([xs[3]] * L))


def test_chain_edges():
    assert cw.chain_edges((3, 1, 2)) == [(3, 1), (1, 2)]
    assert cw.chain_edges((3, 1, 2), wrap=True) == [(3, 1), (1, 2), (2, 3)]


@pytest.mark.parametrize("failed", [None, 5, (6, 9)])
def test_multichain_plan_broadcast_matches_jax_plan(failed):
    """``MultiChainPlan.broadcast`` over a 4x4 mesh (after re-forming
    around failures) delivers what the JAX plan's chains say."""
    dests = [1, 2, 5, 6, 9, 10, 13, 15]
    tp = MultiChainPlan(MeshTopology(4, 4), 0, dests, num_chains=2)
    jp = JPlan(JMesh(4, 4), 0, dests, num_chains=2)
    if failed is not None:
        assert tp.reform(failed) and jp.reform(failed)
    assert tp.chains == jp.chains
    xs = np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32)
    for frames in (1, 2):
        _check(tp.broadcast(_t(xs), num_frames=frames),
               ref.multi_broadcast_ref(xs, 0, jp.chains))


def test_multichain_plan_broadcast_with_every_destination_failed():
    tp = MultiChainPlan(MeshTopology(2, 2), 0, [1, 2, 3], num_chains=1)
    assert tp.reform((1, 2, 3))
    xs = np.arange(8, dtype=np.float32).reshape(4, 2)
    want = np.zeros_like(xs)
    want[0] = xs[0]
    _check(tp.broadcast(_t(xs)), want)


def test_int8_all_reduce_equals_jax_8_device_run(run_multidevice, tmp_path):
    """int8 rs_ag K=2 multi_chain_all_reduce: the port on the stacked
    view equals JAX's shard_map executor on 8 virtual devices bit for
    bit."""
    rings = _rings(2, 4)
    xs = np.random.default_rng(9).standard_normal((L, 48)).astype(np.float32)
    np.save(tmp_path / "xs.npy", xs)
    run_multidevice(f"""
    from repro.core import chainwrite as cw
    xs = jnp.asarray(np.load({str(tmp_path / 'xs.npy')!r}))
    mesh = jax.make_mesh((8,), ('x',))
    f = jax.shard_map(
        lambda v: cw.multi_chain_all_reduce(v[0], 'x', {rings!r}, algo='rs_ag',
                                            wire_dtype='int8')[None],
        mesh=mesh, in_specs=P('x'), out_specs=P('x'))
    np.save({str(tmp_path / 'jax.npy')!r}, np.asarray(jax.jit(f)(xs)))
    """, devices=8)
    want = np.load(tmp_path / "jax.npy")
    got = cw.multi_chain_all_reduce(_t(xs), rings, algo="rs_ag", wire_dtype="int8")
    _check(got, want)
    _check(got, ref.multi_all_reduce_ref(xs, rings, "rs_ag", "int8"))
