"""The port's op-level cost counter (``repro_torch.launch.op_cost``) and
breakdown (``repro_torch.launch.op_breakdown``) against
``repro.launch.hlo_cost`` and ``repro.launch.hlo_breakdown``.

1. A twin of each test of ``tests/test_hlo_cost.py`` on a hand-built
   torch program: a loop of n layers counts n times (eager dispatch books
   every iteration, where HLO needs the trip count), batch dims, free
   views, elementwise flops, collective kinds and group sizes on a fake
   world of 8, an async collective and an ``isend`` counted once,
   ``constant_bytes``, the record order, and the live-bytes tracker's
   peak on a program whose live bytes are known. Exact.
2. The same function in both packages — ``tanh(x @ w)`` three times, and
   a ``lax.scan`` of L layers against a Python loop — with the dot FLOPs
   equal exactly.
3. The smoke cells of yi-6b and mamba2-2.7b: prefill and decode book the
   dot FLOPs of JAX's trip-count-scaled HLO exactly, and
   ``FlopCounterMode``'s count of the same pass. The train cells differ,
   op by op, as :func:`test_train_cell_dot_flops_against_jax` explains.
4. Collective bytes: rank 0's ``collective-permute`` bytes of a ring
   chain all-reduce equal ``chainwrite_dist.sent_wire_bytes(rank=0)`` and
   ``program_wire_bytes`` (which ``tests/test_collective_wire_bytes.py``
   pins JAX's HLO parse to); a TP smoke cell on a ``(2, 2)`` mesh books
   all-reduce and all-gather bytes equal to ``tp.tp_counter``'s.
5. ``overlap_stats`` gives the counts of
   ``tests/test_bucketed_reduce.py``'s hand-built HLO on its torch twin.

A fake world is the ``fake`` testing backend of ``torch.distributed``
(``launch.dryrun.fake_world``), made and destroyed inside each test.
"""

from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import hlo_breakdown, hlo_cost  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import chainwrite as cw  # noqa: E402
from repro_torch.core import chainwrite_dist as cwd  # noqa: E402
from repro_torch.core import program as prg  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_process_mesh  # noqa: E402
from repro_torch.launch.op_breakdown import breakdown, overlap_stats  # noqa: E402
from repro_torch.launch.op_cost import OpCost, analyze, constant_bytes  # noqa: E402
from repro_torch.parallel import tp as tp_mod  # noqa: E402

DOTS = ("mm", "bmm", "addmm", "baddbmm")
# the collectives' current names, where this torch has them
GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
SMOKE = {"train": ("train_smoke", "train", 32, 4),
         "prefill": ("prefill_smoke", "prefill", 32, 2),
         "decode": ("decode_smoke", "decode", 64, 4)}


def dot_flops(records) -> float:
    return sum(r.flops for r in records if r.op in DOTS)


def jax_dot_flops(fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_breakdown.breakdown(text)[2].get("dot", 0.0)


# -- 1. twins of tests/test_hlo_cost.py --------------------------------------


def test_loop_of_n_layers_counts_n_times():
    """The twin of ``test_while_trip_count_multiplies_flops``: ten
    iterations of a (8, 16) @ (16, 16) dot and a scalar add book ten
    times one iteration's flops, with no trip count to read."""

    def f(x, w):
        i = torch.zeros((), dtype=torch.int32)
        for _ in range(10):
            x = x @ w
            i = i + 1
        return x

    cost = analyze(f, torch.zeros(8, 16), torch.zeros(16, 16))
    assert cost.flops == 10 * (2 * 8 * 16 * 16 + 1)


def test_constant_bytes_sums_host_data():
    """The twin of ``test_constant_bytes_sums_all_computations``: a
    (16, 16) f32 table and three int32 scalars made from Python data,
    on the meta device as on a card."""

    def f(x):
        w = torch.tensor([[0.0] * 16] * 16, device="meta")
        n = [torch.tensor(k, dtype=torch.int32, device="meta") for k in (0, 1, 10)]
        return x @ w + n[0] + n[1] + n[2]

    assert constant_bytes(f, torch.empty(8, 16, device="meta")) == 16 * 16 * 4 + 3 * 4


def test_records_in_program_order_with_module_paths():
    """The twin of ``test_parse_module_structure``: the records of an
    ``nn.Sequential`` in program order, each with its first result
    shape and its module path (ModuleTracker's, the layer index
    dropped); views book nothing."""
    net = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.Tanh())
    counter = OpCost()
    counter.run(lambda x: net(x).reshape(-1), torch.zeros(4, 16))
    assert [(r.op, r.shape, r.path) for r in counter.records] == [
        ("addmm", (4, 8), "Sequential"), ("tanh", (4, 8), "Sequential")]


def test_no_fusion_bytes_and_elementwise_flops():
    """The twin of ``test_fusion_boundary_bytes_and_inner_flops``: eager
    mode fuses nothing, so ``x * y + y`` books both ops' operands and
    results (the upper bound) and their results alone (the lower bound);
    one flop an element each."""
    n = 128 * 256
    x, y = torch.zeros(128, 256), torch.zeros(128, 256)
    cost = analyze(lambda a, b: a * b + b, x, y)
    assert cost.flops == 2 * n
    assert cost.bytes == 2 * 3 * n * 4
    assert cost.bytes_lb == 2 * n * 4


def test_collective_wire_bytes():
    """The twin of ``test_collective_wire_bytes`` on a fake world of 8:
    an all-reduce over the world, an all-gather and a reduce-scatter
    over a group of 4 and a send, by JAX's operand rules."""
    b = 64 * 128 * 2  # bf16 payload bytes
    with fake_world(8):
        four = dist.new_group([0, 1, 2, 3])

        def f(x):
            dist.all_reduce(x)
            out = x.new_empty((256, 128))
            GATHER(out, x, group=four)
            SCATTER(x, out, group=four)
            dist.send(x, 1)
            return x

        cost = analyze(f, torch.empty(64, 128, dtype=torch.bfloat16, device="meta"))
    assert cost.coll["all-reduce"] == b
    assert cost.coll["all-gather"] == b  # result / group size
    assert cost.coll["reduce-scatter"] == 4 * b  # result x group size
    assert cost.coll["collective-permute"] == b
    assert cost.coll_bytes == 7 * b


def test_dot_batch_dims():
    cost = analyze(torch.bmm, torch.zeros(4, 32, 64), torch.zeros(4, 64, 16))
    assert cost.flops == 2 * (4 * 32 * 16) * 64


def test_nested_loops_multiply():
    """The twin of ``test_nested_while``: 3 x 5 iterations of ``x + x``
    on f32[4]."""

    def f(x):
        for _ in range(3):
            for _ in range(5):
                x = x + x
        return x

    assert analyze(f, torch.zeros(4)).flops == 3 * 5 * 4


def test_async_collective_and_isend_counted_once():
    """The twin of ``test_async_collective_counted_once``: an async
    all-gather and an ``isend`` are booked when posted; their waits (and
    a ``recv``) add no wire bytes."""
    with fake_world(32):
        def f(x):
            out = x.new_empty((32 * 32,))
            GATHER(out, x, async_op=True).wait()
            dist.isend(x, 1).wait()
            dist.recv(x.new_empty(x.shape), 1)
            return out

        cost = analyze(f, torch.empty(32, device="meta"))
    assert cost.coll["all-gather"] == 32 * 4
    assert cost.coll["collective-permute"] == 32 * 4
    assert cost.coll_bytes == 2 * 32 * 4


def test_free_ops_cost_nothing():
    def f(x):
        return x.view(32, 32).t().detach().t().reshape(-1)[:512].unsqueeze(0), torch.empty(7)

    cost = analyze(f, torch.zeros(1024))
    assert cost.flops == 0 and cost.bytes == 0


def test_live_bytes_peak_of_a_known_program():
    """``a`` and ``b`` live together beside the argument, then ``a`` dies
    before ``c`` is made: the peak is three buffers, the temps two."""
    n = 1 << 20

    def f(x):
        a = x * 2
        b = a + 1
        del a
        return b * 3

    counter = OpCost()
    counter.run(f, torch.empty(n, device="meta"))
    mem = counter.memory_analysis()
    assert mem["argument_size_in_bytes"] == 4 * n
    assert mem["peak_memory_in_bytes"] == 3 * 4 * n
    assert mem["temp_size_in_bytes"] == 2 * 4 * n
    assert mem["output_size_in_bytes"] == 4 * n
    assert mem["alias_size_in_bytes"] == 0


def test_backward_ops_are_booked():
    """Autograd's backward dispatches on this thread: the grads of
    ``sum(tanh(x @ w))`` book the two backward dots, each under its
    node."""
    x = torch.zeros(8, 64, device="meta", requires_grad=True)
    w = torch.zeros(64, 64, device="meta", requires_grad=True)
    counter = OpCost()
    counter.run(lambda a, b: torch.autograd.grad(torch.tanh(a @ b).sum(), (a, b)), x, w)
    dots = [r for r in counter.records if r.op in DOTS]
    assert [r.path for r in dots] == ["", "/MmBackward0", "/MmBackward0"]
    assert dot_flops(counter.records) == 3 * 2 * 8 * 64 * 64


# -- 2. the same function in both packages ------------------------------------


def test_real_module_dot_flops_equal_jax():
    """``test_real_module_smoke``'s function: JAX's compiled dots and the
    port's booked dots, equal exactly."""

    def jf(x, w):
        for _ in range(3):
            x = jnp.tanh(x @ w)
        return x.sum()

    def tf(x, w):
        for _ in range(3):
            x = torch.tanh(x @ w)
        return x.sum()

    want = jax_dot_flops(jf, jnp.zeros((8, 64)), jnp.zeros((64, 64)))
    counter = OpCost()
    counter.run(tf, torch.zeros(8, 64), torch.zeros(64, 64))
    assert want == dot_flops(counter.records) == 3 * 2 * 8 * 64 * 64
    assert counter.flop_counter_flops == want
    assert counter.cost.bytes > 0


def test_scan_of_layers_equals_python_loop():
    """A ``lax.scan`` of L layers (a ``while`` whose trip count the HLO
    parse multiplies) against the port's Python loop over the stacked
    weights."""
    L = 6

    def jf(x, ws):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    def tf(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    want = jax_dot_flops(jf, jnp.zeros((4, 32)), jnp.zeros((L, 32, 32)))
    got = analyze(tf, torch.zeros(4, 32), torch.zeros(L, 32, 32)).flops - L * 4 * 32
    assert want == got == L * 2 * 4 * 32 * 32


def _conv_program(x, w):
    y = torch.nn.functional.conv1d(x, w, padding=2, groups=4)
    return torch.autograd.grad(y.square().sum(), (x, w))


def _attention_program(q, k, v):
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    return torch.autograd.grad(o.sum(), (q, k, v))


def _dense_program(x, w):
    return torch.autograd.grad(torch.tanh(torch.tanh(x @ w) @ w.t()).sum(), (x, w))


FLOP_PROGRAMS = {
    "conv1d": (_conv_program, lambda: (torch.randn(2, 4, 32, requires_grad=True),
                                       torch.randn(8, 1, 5, requires_grad=True))),
    # on meta tensors, as in a dry run (the CPU's fused attention kernel
    # is one neither count prices)
    "sdpa": (_attention_program, lambda: tuple(
        torch.empty(2, 4, 16, 8, device="meta", requires_grad=True) for _ in range(3))),
    "dense": (_dense_program, lambda: (torch.randn(8, 32, requires_grad=True),
                                       torch.randn(32, 16, requires_grad=True))),
}


@pytest.mark.parametrize("name", sorted(FLOP_PROGRAMS))
def test_flop_counter_flops_are_flop_counter_modes(name):
    """``flop_counter_flops`` applies ``FlopCounterMode``'s registry in
    the counter's own pass: the same total as a ``FlopCounterMode`` run
    of the program, forward and backward (convolution, attention and
    dots)."""
    from torch.utils.flop_counter import FlopCounterMode

    fn, make = FLOP_PROGRAMS[name]
    args = make()
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    counter = OpCost()
    counter.run(fn, *args)
    assert counter.flop_counter_flops == mode.get_total_flops() > 0


# -- 3. the smoke cells ---------------------------------------------------------


@pytest.fixture
def smoke_shapes(monkeypatch):
    for name, kind, seq, batch in SMOKE.values():
        monkeypatch.setitem(JC.SHAPES, name, JC.Shape(name, kind, seq, batch))
        monkeypatch.setitem(TC.SHAPES, name, TC.Shape(name, kind, seq, batch))


def jax_cell_items(arch: str, kind: str):
    cell = JS.build_cell(arch, SMOKE[kind][0], jax_host_mesh(model=1), smoke=True)
    return hlo_breakdown.breakdown(cell.lower().compile().as_text())


def port_cell(arch: str, kind: str) -> OpCost:
    cell = TS.build_cell(arch, SMOKE[kind][0], make_host_mesh(data=2), smoke=True)
    counter = OpCost()
    counter.run(cell.step_fn, *cell.args)
    return counter


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_cell_dot_flops_equal_jax(arch, kind, smoke_shapes):
    """Prefill and decode: the port's dots are JAX's trip-count-scaled
    dots, exactly (mamba2's depthwise conv is a ``convolution`` in JAX's
    HLO and elementwise in the port, so it is not a dot in either)."""
    _, _, by_flops = jax_cell_items(arch, kind)
    counter = port_cell(arch, kind)
    assert dot_flops(counter.records) == by_flops["dot"] == counter.flop_counter_flops


_NODE = re.compile(r"/\w+Backward\d*$")


def _port_phases(records) -> dict[str, float]:
    """Dot FLOPs by phase: the forward (no autograd node), the remat
    recompute (a node, under the model's layer functions: the
    checkpointed layer run again inside the backward) and the backward
    proper."""
    out = {"forward": 0.0, "recompute": 0.0, "backward": 0.0}
    for r in records:
        if r.op not in DOTS:
            continue
        if not _NODE.search(r.path):
            out["forward"] += r.flops
        elif "transformer.body" in r.path:
            out["recompute"] += r.flops
        else:
            out["backward"] += r.flops
    return out


def _jax_phases(items) -> dict[str, float]:
    """JAX's dot FLOPs by the op_name metadata: ``rematted_computation``
    (the recompute), ``transpose(`` (the backward), else the forward."""
    out = {"forward": 0.0, "recompute": 0.0, "backward": 0.0}
    for _, f, _, name, _, meta in items:
        if not name.startswith("dot"):
            continue
        elif "rematted_computation" in meta:
            out["recompute"] += f
        elif "transpose(" in meta:
            out["backward"] += f
        else:
            out["forward"] += f
    return out


# (JAX's, the port's) dot FLOPs of the smoke train cell by phase, and
# JAX's convolution FLOPs
TRAIN_PHASES = {
    "yi-6b": ({"forward": 25165824, "recompute": 2097152, "backward": 50331648,
               "convolution": 0},
              {"forward": 25165824, "recompute": 2097152, "backward": 50331648}),
    "mamba2-2.7b": ({"forward": 19922944, "recompute": 2097152, "backward": 39911424,
                     "convolution": 34991104},
                    {"forward": 19922944, "recompute": 2097152, "backward": 39845888}),
}


@pytest.mark.parametrize("arch", sorted(TRAIN_PHASES))
def test_train_cell_dot_flops_against_jax(arch, smoke_shapes):
    """The train cells' dot FLOPs equal JAX's phase by phase, the remat's
    recompute included (yi-6b: 77,594,624 in both; mamba2-2.7b:
    61,865,984 against JAX's 61,931,520 plus 34,991,104 in
    ``convolution``):

    * the forward's dots are equal;
    * ``remat="dots"`` saves every dot without batch dims and recomputes
      only the batched ones (attention's einsums, the SSD chunk einsums:
      2,097,152 in both) — JAX's ``checkpoint_dots_with_no_batch_dims``,
      the port's selective checkpoint that saves ``mm``/``addmm``;
    * the backward proper is equal for yi-6b; for mamba2-2.7b JAX's has
      one more dot of 65,536 FLOPs (the grad of the three-operand
      chunk-state einsum ``bcqh,bcqhn,bcqhp->bchnp`` with respect to its
      ``bcqh`` operand, a dot in XLA and a multiply and sum in the
      port's autograd);
    * mamba2's depthwise causal conv is an XLA ``convolution`` (its
      forward and its backward's weight grad, priced by ``_conv_flops``)
      and elementwise multiply-adds in the port, which book no dot.

    The port's dots also equal ``FlopCounterMode``'s count."""
    jax_want, port_want = TRAIN_PHASES[arch]
    items, _, by_flops = jax_cell_items(arch, "train")
    counter = port_cell(arch, "train")
    assert {**_jax_phases(items), "convolution": by_flops.get("convolution", 0)} == jax_want
    assert _port_phases(counter.records) == port_want
    assert by_flops["dot"] == sum(v for k, v in jax_want.items() if k != "convolution")
    assert not any(r.op == "convolution" for r in counter.records)
    assert dot_flops(counter.records) == counter.flop_counter_flops == sum(port_want.values())


# -- 4. collective bytes ---------------------------------------------------------


@pytest.mark.parametrize("L", [4, 8])
def test_ring_all_reduce_permute_bytes_are_sent_wire_bytes(L):
    """Rank 0 of a ring chain all-reduce on a fake world (the process-form
    executor on meta tensors): its ``collective-permute`` bytes equal
    ``sent_wire_bytes(rank=0)``, ``program_wire_bytes`` and the executor's
    own ``wire_counter``."""
    with fake_world(L):
        cwd.wire_counter.reset()
        counter = OpCost()
        counter.run(lambda x: cw.chain_all_reduce(x, group=dist.group.WORLD),
                    torch.empty(1000, 3, device="meta"))
        ((prog, size, frames, rank),) = cwd.wire_counter.runs
    permute = counter.cost.coll["collective-permute"]
    assert rank == 0 and frames == 1
    assert permute == cwd.sent_wire_bytes(prog, size, rank=0) == prg.program_wire_bytes(
        prog, size) == cwd.wire_counter.bytes > 0
    assert counter.cost.coll_bytes == permute


def test_constant_bytes_grow_with_the_ring_length():
    """JAX's symbolic shard addressing keeps the executor's HLO
    constants the same at any ring length L (``hlo_cost.constant_bytes``);
    the port's process-form executor builds its rank's row of each
    addressing table as an index tensor, whose bytes grow with L
    (ROADMAP §3). The rows are built once per (program, device, rank)
    and kept on the program, which the planner caches: each count drops
    what an earlier run built first."""
    out = {}
    for L in (4, 8, 16):
        prg.plan_all_reduce(L, (tuple(range(L)),)).__dict__.pop("_torch_dist_tables", None)
        with fake_world(L):
            out[L] = constant_bytes(lambda x: cw.chain_all_reduce(x, group=dist.group.WORLD),
                                    torch.empty(1024, device="meta"))
    assert out[4] < out[8] < out[16]
    assert out == {4: 128, 8: 256, 16: 512}  # 32 bytes a ring member


def test_tp_cell_collective_bytes_equal_tp_counter(smoke_shapes):
    """A yi-6b smoke prefill cell on a fake ``(data, model) = (2, 2)``
    process mesh: rank 0's all-reduce and all-gather bytes are the
    payloads ``tp.tp_counter`` counts (the all-gathers of the
    vocab-split head and the all-reduces of the row-split projections)."""
    with fake_world(4):
        mesh = make_process_mesh(model=2)
        cell = TS.build_cell("yi-6b", "prefill_smoke", mesh, smoke=True)
        tp_mod.tp_counter.reset()
        counter = OpCost()
        counter.run(cell.step_fn, *cell.args)
        counted = sum(tp_mod.tp_counter.bytes.values())
    coll = counter.cost.coll
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    assert coll["all-reduce"] + coll["all-gather"] == counted
    assert coll["reduce-scatter"] == coll["all-to-all"] == coll["collective-permute"] == 0


# -- 5. overlap_stats ------------------------------------------------------------


def test_overlap_stats_counts_async_and_interleavings():
    """The torch twin of ``test_bucketed_reduce.py``'s HLO: an async
    all-reduce with compute in its shadow, a synchronous send (the
    collective-permute), compute, an all-gather."""
    with fake_world(2):
        def f(p0):
            work = dist.all_reduce(p0, async_op=True)
            f0 = p0 * 2
            work.wait()
            dist.send(f0, 1)
            f1 = f0 * 3
            out = f1.new_empty((128,))
            GATHER(out, f1)
            return out

        counter = OpCost()
        counter.run(f, torch.empty(64, device="meta"))
    s = overlap_stats(counter)
    assert (s["async_start"], s["async_done"], s["max_in_flight"], s["collectives"],
            s["interleavings"]) == (1, 1, 1, 3, 2)
    empty = overlap_stats(OpCost().trace)
    assert empty["collectives"] == 0 and empty["interleavings"] == 0


def test_breakdown_merges_repeats_into_counts():
    """Identical records (op, shape, path) merge: a 5-layer loop's dot is
    one item ``x5``; the per-op totals are the cost's."""

    def f(x, w):
        for _ in range(5):
            x = torch.tanh(x @ w)
        return x

    counter = OpCost()
    counter.run(f, torch.zeros(4, 32), torch.zeros(32, 32))
    items, by_bytes, by_flops = breakdown(counter)
    assert sorted((n, op) for _, _, n, op, _, _ in items) == [(5, "mm"), (5, "tanh")]
    assert by_flops == {"mm": 5 * 2 * 4 * 32 * 32, "tanh": 5 * 4 * 32}
    assert sum(by_bytes.values()) == counter.cost.bytes
    assert hlo_cost.COLLECTIVE_KINDS == tuple(counter.cost.coll)


def test_bucketed_reduce_runs_after_backward(smoke_shapes):
    """JAX's bucketed step schedules each bucket's reduce inside the
    backward (``tests/test_bucketed_reduce.py``: backward fusions between
    bucket reduces). The port's step takes every grad from
    ``torch.autograd.grad`` first and then reduces the buckets, so in
    rank 0's op trace (yi-6b smoke, Torrent, ``bucketed``, a fake world
    of 2 on ``data``) the ring's first send comes after the last backward
    op, and the only compute between its sends is the chain program's own
    combine; ``op_overlap``'s interleavings are those and the optimizer's
    (ROADMAP §3)."""
    with fake_world(2):
        mesh = make_process_mesh(data=2)
        cell = TS.build_cell("yi-6b", "train_smoke", mesh, smoke=True, collectives="torrent",
                             variant="bucketed")
        counter = OpCost()
        counter.run(cell.step_fn, *cell.args)
    recs = counter.records
    last_backward = max(i for i, r in enumerate(recs) if _NODE.search(r.path))
    sends = [i for i, r in enumerate(recs) if r.op == "send"]
    assert len(sends) == 2 and sends[0] > last_backward
    between = [(r.op, r.path.rsplit("/", 1)[-1]) for r in recs[sends[0]:sends[-1]]
               if r.kind is None and r.flops]
    assert between == [("add_", "chainwrite_dist.interpret_program")]
    s = overlap_stats(counter)
    assert (s["async_start"], s["async_done"], s["max_in_flight"], s["collectives"],
            s["interleavings"]) == (2, 2, 1, 15, 3)
