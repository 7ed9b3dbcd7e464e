"""Chainwrite collectives on one card: the ChainProgram executor on the
stacked global view — the port of ``repro.core.chainwrite``.

The JAX package runs a :class:`~repro_torch.core.program.ChainProgram`
inside ``shard_map``, one ppermute per step. One card has no mesh, so
the port runs the same program on the *stacked global view* that the
numpy oracle (:func:`.chainwrite_ref.interpret_program`) uses: row ``d``
of a ``(L, ...)`` tensor is virtual device ``d``.

* A hop is an index gather along dim 0 (``index_select``); rows that no
  edge targets receive zeros.
* ``wire_dtype="int8"`` quantizes each row's whole buffer with its own
  scale (:func:`~repro_torch.runtime.compression.quantize_rows`), ships
  the int8 rows and scales, and dequantizes at the destination; the
  combine accumulates in f32.
* The ADD combine is the oracle's elementwise ``buf + rows(...)``;
  writes go through ``index_copy_`` on slots that ``validate()`` proves
  distinct. No ``index_add_``/``scatter_add_`` (non-deterministic on
  CUDA), no reduction over a dim, no TF32: the executor is bit-exact
  against the oracle on the CPU and on the card.

Addressing tables (dense or symbolic) are resolved once per program and
device with :func:`.program.resolve_table` into ``(L, width)`` int64
index tensors and cached on the program.

Every public collective is a thin ``plan_* -> execute_program`` wrapper
with the JAX signature minus the axis name: the axis is dim 0 of ``x``.
``chain_broadcast`` / ``multi_chain_broadcast`` take ``x`` as ``(L, n,
...)`` (the head's row is the payload) and return ``(L, n, ...)``; the
ring collectives take the global view that ``chainwrite_ref``'s oracles
take and return what they return.

``group=`` (a ``torch.distributed`` group; ``dist.group.WORLD`` for the
whole world) runs the same program one rank per process instead
(:mod:`.chainwrite_dist`): the axis is the group, ``x`` is this rank's
own view with JAX's per-device shapes, and the result is this rank's.
``group=None`` is the stacked view.

:data:`wire_counter` counts the bytes that cross an edge, step by step:
per step, the executor's permute count (``Step.num_permutes``) times the
bytes of one edge's frame (an int8 frame plus its 4-byte scale on a
compressed wire). Over the programs it ran, the count equals
``program_wire_bytes`` (``pipelined_wire_bytes`` for frame-pipelined
broadcasts) of each at its per-device payload size, taken at f32 for a
program with an int8 wire (a bf16 payload is widened before it is
quantized).
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch

from repro_torch.runtime.compression import dequantize_rows, quantize_rows

from . import chainwrite_dist as cwd
from . import program as prg
from .program import ALL_REDUCE_ALGOS, ChainProgram, validate_ring_partition
from .scheduling import FailureSpec, normalize_failed

__all__ = [
    "ALL_REDUCE_ALGOS",
    "WireCounter",
    "chain_all_gather",
    "chain_all_reduce",
    "chain_all_to_all",
    "chain_broadcast",
    "chain_edges",
    "chain_reduce_scatter",
    "degraded_chains",
    "degraded_multi_chain_broadcast",
    "execute_program",
    "interpret_program",
    "multi_chain_all_gather",
    "multi_chain_all_reduce",
    "multi_chain_all_to_all",
    "multi_chain_broadcast",
    "multi_chain_reduce_scatter",
    "validate_ring_partition",
    "wire_counter",
    "xla_broadcast",
]


class WireCounter:
    """Bytes the executor put on the wire, and the programs it ran.

    ``bytes`` and ``steps`` accumulate per executed step; ``runs``
    counts the calls of :func:`execute_program` per ``(program,
    per-device payload bytes, num_frames)``, so :meth:`modeled_bytes`
    prices the same runs with the IR's byte model. A training loop runs
    the same few programs at the same sizes every step, so ``runs``
    stays as small as one step's set of distinct calls however long the
    loop runs."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.bytes = 0
        self.steps = 0
        self.runs: Counter[tuple[ChainProgram, int, int]] = Counter()

    def record(self, prog: ChainProgram, size: int, num_frames: int) -> None:
        self.runs[prog, size, num_frames] += 1

    def modeled_bytes(self) -> int:
        return sum(
            n * prg.pipelined_wire_bytes(p, size, frames)
            for (p, size, frames), n in self.runs.items()
        )


wire_counter = WireCounter()


def chain_edges(order: Sequence[int], *, wrap: bool = False) -> list[tuple[int, int]]:
    """Directed (src, dst) pairs for a chain (optionally closed ring)."""
    edges = [(int(a), int(b)) for a, b in zip(order, order[1:])]
    if wrap and len(order) > 1:
        edges.append((int(order[-1]), int(order[0])))
    return edges


# ---------------------------------------------------------------------------
# Index tables, resolved once per (program, device)
# ---------------------------------------------------------------------------


class _Rows:
    """A resolved addressing table: ``idx`` (L·width,) flat gather
    indices into an ``(L·A, ...)`` source, ``mask`` (L, width) of live
    entries, and whether every entry is live / none is."""

    __slots__ = ("width", "idx", "mask", "full", "empty")

    def __init__(self, table, L: int, bound: int, device) -> None:
        t = torch.tensor(table, dtype=torch.int64).reshape(L, -1)
        self.width = t.shape[1]
        live = t >= 0
        self.full = bool(live.all())
        self.empty = not bool(live.any())
        base = torch.arange(L, dtype=torch.int64)[:, None] * bound
        self.idx = (base + t.clamp(min=0)).reshape(-1).to(device)
        self.mask = live.to(device)


class _Write:
    """A resolved write table: ``out_flat[dst] (op)= buf_flat[src]``
    over the live entries (distinct per device, as ``validate()``
    proves); ``every_row`` when those entries are all of ``buf``'s
    rows, in order."""

    __slots__ = ("src", "dst", "n", "every_row")

    def __init__(self, table, L: int, width: int, slots: int, device) -> None:
        src, dst = [], []
        for d in range(L):
            for j, s in enumerate(table[d]):
                if s >= 0:
                    src.append(d * width + j)
                    dst.append(d * slots + s)
        self.n = len(src)
        self.every_row = src == list(range(L * width))
        self.src = torch.tensor(src, dtype=torch.int64, device=device)
        self.dst = torch.tensor(dst, dtype=torch.int64, device=device)


class _Hop:
    """One step's edge set as a gather: ``new[d] = buf[src[d]]`` where
    some edge targets ``d``, zeros elsewhere."""

    __slots__ = ("src", "mask", "full", "empty", "permutes")

    def __init__(self, edges, L: int, device) -> None:
        src = [-1] * L
        for s, d in edges:
            src[d] = s
        t = torch.tensor(src, dtype=torch.int64)
        live = t >= 0
        self.full = bool(live.all())
        self.empty = not bool(live.any())
        self.src = t.clamp(min=0).to(device)
        self.mask = live.to(device)
        self.permutes = prg.Step(tuple(edges)).num_permutes()


def _tables(prog: ChainProgram, device: torch.device) -> dict:
    """Per-(program, device) cache of resolved tables, kept on the
    program object (planners memoize programs, so a training loop
    resolves each table once)."""
    cache = prog.__dict__.get("_torch_tables")
    if cache is None:
        cache = {}
        object.__setattr__(prog, "_torch_tables", cache)
    key = str(device)
    if key not in cache:
        cache[key] = {}
    return cache[key]


def _rows_table(prog, table, bound: int, device) -> _Rows:
    cache = _tables(prog, device)
    key = ("rows", id(table), bound)
    hit = cache.get(key)
    if hit is None or hit[0] is not table:
        hit = (table, _Rows(prg.resolve_table(prog, table), prog.num_devices, bound, device))
        cache[key] = hit
    return hit[1]


def _write_table(prog, step, device) -> _Write:
    cache = _tables(prog, device)
    key = ("write", id(step))
    hit = cache.get(key)
    if hit is None or hit[0] is not step:
        tbl = prg.resolve_table(prog, step.write)
        hit = (step, _Write(tbl, prog.num_devices, step.width, prog.out_slots, device))
        cache[key] = hit
    return hit[1]


def _hop_table(prog, edges, device) -> _Hop:
    cache = _tables(prog, device)
    key = ("hop", id(edges))
    hit = cache.get(key)
    if hit is None or hit[0] is not edges:
        hit = (edges, _Hop(edges, prog.num_devices, device))
        cache[key] = hit
    return hit[1]


def _bcast_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def _rows(prog, table, source: torch.Tensor, keep: torch.Tensor | None = None):
    """``result[d, j] = source[d, table[d][j]]``; ``-1`` gives
    ``keep[d, j]`` (same width) or zeros — the oracle's ``rows``."""
    L, A = source.shape[:2]
    inner = source.shape[2:]
    r = _rows_table(prog, table, A, source.device)
    if r.empty:
        if keep is not None and keep.shape[1] == r.width:
            return keep
        return source.new_zeros((L, r.width) + inner)
    got = source.reshape((L * A,) + inner).index_select(0, r.idx)
    got = got.reshape((L, r.width) + inner)
    if r.full:
        return got
    mask = _bcast_mask(r.mask, got.dim())
    if keep is not None and keep.shape[1] == r.width:
        return torch.where(mask, got, keep)
    return torch.where(mask, got, got.new_zeros(()))


def _hop(prog, step, buf: torch.Tensor, wire: str | None) -> torch.Tensor:
    """Ship every row's buffer over the step's edges. On the int8 wire
    the int8 rows and their scales travel; the destination dequantizes.
    Counts the step's wire bytes."""
    h = _hop_table(prog, step.edges, buf.device)
    row_numel = buf[0].numel()
    if wire == "int8":
        q, scale = quantize_rows(buf)
        wire_counter.bytes += h.permutes * (row_numel + 4)
    else:
        wire_counter.bytes += h.permutes * row_numel * buf.element_size()
    wire_counter.steps += 1
    if h.empty:
        return torch.zeros_like(buf)
    if wire == "int8":
        q = q.index_select(0, h.src)
        scale = scale.index_select(0, h.src)
        if not h.full:
            q = torch.where(_bcast_mask(h.mask, q.dim()), q, q.new_zeros(()))
            scale = torch.where(h.mask, scale, scale.new_zeros(()))
        return dequantize_rows(q, scale)
    new = buf.index_select(0, h.src)
    if not h.full:
        new = torch.where(_bcast_mask(h.mask, new.dim()), new, new.new_zeros(()))
    return new


def _write(prog, step, buf: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    w = _write_table(prog, step, buf.device)
    if w.n == 0:
        return out
    L = buf.shape[0]
    inner = buf.shape[2:]
    vals = buf.reshape((L * buf.shape[1],) + inner)
    if not w.every_row:
        vals = vals.index_select(0, w.src)
    flat = out.reshape((L * out.shape[1],) + inner)
    if step.write_op != prg.COPY:
        vals = flat.index_select(0, w.dst).add_(vals)  # the oracle's out + buf
    flat.index_copy_(0, w.dst, vals)
    return out


def interpret_program(shards: torch.Tensor, prog: ChainProgram) -> torch.Tensor:
    """Run ``prog`` on the pre-blocked global view ``shards`` (``(L,
    addr_shards, m, ...)``); returns the out slots ``(L, out_slots, m,
    ...)`` — the torch twin of ``chainwrite_ref.interpret_program``,
    step for step (load, hop, combine, write). The combine and an ADD
    write accumulate in place into tensors the step made itself, which
    rounds as the oracle's ``buf + rows`` and ``out + buf`` do and holds
    one temporary of the buffer's size where those forms hold two."""
    L = prog.num_devices
    if shards.dim() < 2 or shards.shape[0] != L or shards.shape[1] != prog.addr_shards:
        raise ValueError(
            f"shards {tuple(shards.shape)} incompatible with program "
            f"(L={L}, addr_shards={prog.addr_shards})"
        )
    wires = [prog.step_wire_dtype(s) for s in prog.steps]
    orig_dtype = shards.dtype
    if any(w is not None for w in wires):
        # the compressed wire computes in f32
        if not shards.is_floating_point():
            raise ValueError(
                f"wire_dtype='int8' requires a floating payload, got {shards.dtype}"
            )
        shards = shards.to(torch.float32)
    buf = _rows(prog, prog.buf_init, shards)
    out = _rows(prog, prog.out_init, shards)  # a fresh tensor: written in place
    for step, wire in zip(prog.steps, wires):
        if step.load is not None:
            buf = _rows(prog, step.load, out, keep=buf)
        buf = _hop(prog, step, buf, wire)
        if step.combine == prg.ADD:
            src = shards if step.add_from == "input" else out
            buf = buf.add_(_rows(prog, step.add_src, src))  # a fresh hop result
        if step.write is not None:
            out = _write(prog, step, buf, out)
    return out.to(orig_dtype)


def _execute_pipeline(x: torch.Tensor, prog: ChainProgram, num_frames: int) -> torch.Tensor:
    """Broadcast programs: the stepped interpreter for a single frame,
    or the store-and-forward frame pipeline (every chain edge applied
    on each of F + L - 2 slots, the head injecting frame t at slot t)."""
    L = prog.num_devices
    if num_frames <= 1 or not prog.steps:
        return interpret_program(x[:, None], prog)[:, 0]
    if x.shape[1] % num_frames != 0:
        raise ValueError(
            f"leading dim {x.shape[1]} not divisible by num_frames={num_frames}"
        )
    head = int(prog.head)
    frames = x[head].reshape((num_frames, x.shape[1] // num_frames) + x.shape[2:])
    cache = _tables(prog, x.device)
    if "pipeline" not in cache:
        pos = [len(prog.steps) + 1] * L
        pos[head] = 0
        for t, step in enumerate(prog.steps):
            for _, dst in step.edges:
                pos[dst] = t + 1
        cache["pipeline"] = (pos, prg.Step(tuple(e for s in prog.steps for e in s.edges)))
    pos, hop = cache["pipeline"]
    max_len = len(prog.steps) + 1
    out = x.new_zeros((L,) + frames.shape)
    out[head] = frames
    buf = x.new_zeros((L,) + frames.shape[1:])
    for t in range(num_frames + max_len - 2):
        if t < num_frames:
            buf[head] = frames[t]
        buf = _hop(prog, hop, buf, None)
        # after hop t, the member at chain position p holds frame t-(p-1)
        for d in range(L):
            f = t - (pos[d] - 1)
            if 0 < pos[d] < max_len and 0 <= f < num_frames:
                out[d, f] = buf[d]
    return out.reshape(x.shape)


def execute_program(
    x: torch.Tensor,
    prog: ChainProgram,
    *,
    num_frames: int = 1,
    tiled: bool = False,
    group=None,
) -> torch.Tensor:
    """Run a :class:`ChainProgram` on the global view ``x`` (row ``d`` =
    virtual device ``d``), with ``execute_program``'s per-collective
    blocking and assembly: ``broadcast`` takes/returns ``(L, n, ...)``
    (``num_frames`` pipelines it); ``all_gather`` stacks (or, ``tiled``,
    concatenates) the rows; ``reduce_scatter``/``all_to_all`` take ``(L,
    L, ...)`` chunk trains; ``all_reduce`` zero-pads dim 1 to the
    program's shard count and unpads on the way out. With a ``group``,
    ``x`` is this rank's view and the program runs one rank per process
    (:func:`.chainwrite_dist.execute_program`)."""
    if group is not None:
        return cwd.execute_program(x, prog, group=group, num_frames=num_frames, tiled=tiled)
    L = prog.num_devices
    if x.dim() < 1 or x.shape[0] != L:
        raise ValueError(f"global view has {x.shape[0] if x.dim() else 0} rows, "
                         f"program planned for {L} devices")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"execute_program: unsupported device {x.device}")
    c = prog.collective
    # per-device payload bytes; an int8 wire computes in f32, as the
    # byte model assumes, whatever the payload's own dtype
    compressed = any(prog.step_wire_dtype(s) is not None for s in prog.steps)
    elem = 4 if compressed else x.element_size()
    size = x[0].numel() * elem
    if c == "broadcast":
        wire_counter.record(prog, size, max(1, num_frames))
        return _execute_pipeline(x, prog, num_frames)
    if c == "all_gather":
        wire_counter.record(prog, size, 1)
        out = interpret_program(x[:, None], prog)
        if tiled:
            out = out.reshape((L, L * x.shape[1]) + x.shape[2:])
        return out
    if c in ("reduce_scatter", "all_to_all"):
        if x.dim() < 2 or x.shape[1] != L:
            raise ValueError(f"leading dim {x.shape[1]} != axis size {L}")
        wire_counter.record(prog, size, 1)
        out = interpret_program(x, prog)
        return out[:, 0] if c == "reduce_scatter" else out
    if c == "all_reduce":
        S = prog.addr_shards
        lead = x.shape[1]
        pad = (-lead) % S
        if pad:
            xp = x.new_zeros((L, lead + pad) + x.shape[2:])
            xp[:, :lead] = x
        else:
            xp = x
        wire_counter.record(prog, xp[0].numel() * elem, 1)
        shards = xp.reshape((L, S, xp.shape[1] // S) + x.shape[2:])
        out = interpret_program(shards, prog)
        if prog.out_slots == 1:  # rotation: whole payload in one slot
            full = out[:, 0]
        else:
            full = out.reshape((L, out.shape[1] * out.shape[2]) + x.shape[2:])
        return full[:, :lead] if pad else full
    raise ValueError(f"unknown collective {c!r}")


def _axis(x: torch.Tensor, group) -> int:
    """The axis size: dim 0 of the stacked view, or the group's size."""
    return x.shape[0] if group is None else cwd.group_size(group)


# ---------------------------------------------------------------------------
# P2MP broadcast
# ---------------------------------------------------------------------------


def chain_broadcast(
    x: torch.Tensor, order: Sequence[int], *, num_frames: int = 1, group=None
) -> torch.Tensor:
    """Multicast row ``order[0]`` of ``x`` to every row in ``order`` by
    store-and-forward chaining; rows outside ``order`` get zeros.
    ``num_frames > 1`` pipelines frames of dim 1 down the chain. With a
    ``group``, ``x`` is this rank's payload (the head's is sent)."""
    order = tuple(int(o) for o in order)
    if len(order) == 0:
        raise ValueError("empty chain")
    prog = prg.plan_broadcast(
        _axis(x, group), order[0], (order[1:],) if len(order) > 1 else ()
    )
    return execute_program(x, prog, num_frames=num_frames, group=group)


def multi_chain_broadcast(
    x: torch.Tensor,
    head: int,
    chains: Sequence[Sequence[int]],
    *,
    num_frames: int = 1,
    group=None,
) -> torch.Tensor:
    """Multicast row ``head`` of ``x`` down K disjoint sub-chains
    (destination orders, head excluded). The head and every chain
    member end with the head's payload; other rows get zeros."""
    clean = prg.validate_chains(int(head), chains)
    if not clean:
        raise ValueError("empty chain set")
    prog = prg.plan_broadcast(_axis(x, group), int(head), clean)
    return execute_program(x, prog, num_frames=num_frames, group=group)


def degraded_chains(
    chains: Sequence[Sequence[int]], failed: FailureSpec
) -> list[tuple[int, ...]]:
    """Splice the ``failed`` member(s) out of their sub-chains (relative
    order kept); chains emptied by the splice are dropped."""
    dead = set(normalize_failed(failed))
    members = {int(d) for c in chains for d in c}
    missing = sorted(dead - members)
    if missing:
        raise ValueError(f"failed node(s) {missing} are in no chain")
    out: list[tuple[int, ...]] = []
    for c in chains:
        kept = tuple(int(d) for d in c if int(d) not in dead)
        if kept:
            out.append(kept)
    return out


def degraded_multi_chain_broadcast(
    x: torch.Tensor,
    head: int,
    chains: Sequence[Sequence[int]],
    failed: FailureSpec,
    *,
    num_frames: int = 1,
    group=None,
) -> torch.Tensor:
    """:func:`multi_chain_broadcast` with the ``failed`` member(s)
    dropped: survivors get the payload, the failed rows zeros."""
    head = int(head)
    if head in set(normalize_failed(failed)):
        raise ValueError("the initiator (head) cannot be dropped")
    remaining = degraded_chains(chains, failed)
    if not remaining:  # every destination failed: head keeps its payload
        prog = prg.plan_broadcast(_axis(x, group), head, ())
        return execute_program(x, prog, num_frames=num_frames, group=group)
    return multi_chain_broadcast(x, head, remaining, num_frames=num_frames, group=group)


# ---------------------------------------------------------------------------
# Ring collectives over a scheduled order
# ---------------------------------------------------------------------------


def _ring_args(L: int, order: Sequence[int] | None) -> tuple[int, ...]:
    order = tuple(range(L)) if order is None else tuple(int(o) for o in order)
    if sorted(order) != list(range(L)):
        raise ValueError("ring order must be a permutation of the whole axis")
    return order


def chain_all_gather(
    x: torch.Tensor, order: Sequence[int] | None = None, *, tiled: bool = False, group=None
) -> torch.Tensor:
    """Ring all-gather: every row ends with the stacked (or, ``tiled``,
    concatenated) rows of ``x``, indexed by device id."""
    L = _axis(x, group)
    return execute_program(x, prg.plan_all_gather(L, (_ring_args(L, order),)), tiled=tiled,
                           group=group)


def multi_chain_all_gather(
    x: torch.Tensor, orders: Sequence[Sequence[int]], *, tiled: bool = False, group=None
) -> torch.Tensor:
    """All-gather over K disjoint equal-size sub-rings."""
    L = _axis(x, group)
    orders = tuple(validate_ring_partition(L, orders))
    return execute_program(x, prg.plan_all_gather(L, orders), tiled=tiled, group=group)


def chain_reduce_scatter(
    x: torch.Tensor, order: Sequence[int] | None = None, *, group=None
) -> torch.Tensor:
    """Ring reduce-scatter: ``x`` is ``(L, L, ...)`` (row ``d``'s chunk
    ``j`` goes to device ``j``); row ``d`` of the result is the reduced
    chunk ``d``."""
    L = _axis(x, group)
    return execute_program(x, prg.plan_reduce_scatter(L, (_ring_args(L, order),)),
                           group=group)


def multi_chain_reduce_scatter(
    x: torch.Tensor, orders: Sequence[Sequence[int]], *, group=None
) -> torch.Tensor:
    """Reduce-scatter over K disjoint equal-size sub-rings."""
    L = _axis(x, group)
    orders = tuple(validate_ring_partition(L, orders))
    return execute_program(x, prg.plan_reduce_scatter(L, orders), group=group)


def chain_all_reduce(
    x: torch.Tensor,
    order: Sequence[int] | None = None,
    *,
    wire_dtype: str | None = None,
    group=None,
) -> torch.Tensor:
    """Ring all-reduce (reduce-scatter + all-gather) of the rows of
    ``x`` (``(L, n, ...)``); ``wire_dtype="int8"`` ships every hop
    quantized."""
    L = _axis(x, group)
    prog = prg.plan_all_reduce(L, (_ring_args(L, order),), wire_dtype=wire_dtype)
    return execute_program(x, prog, group=group)


def multi_chain_all_reduce(
    x: torch.Tensor,
    orders: Sequence[Sequence[int]],
    *,
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    group=None,
) -> torch.Tensor:
    """All-reduce over K disjoint equal-size sub-rings (``algo`` is
    ``"rs_ag"`` or ``"rotation"``; K = 1 is the single ring)."""
    if algo not in ALL_REDUCE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}; expected {ALL_REDUCE_ALGOS}")
    L = _axis(x, group)
    orders = tuple(validate_ring_partition(L, orders))
    return execute_program(x, prg.plan_all_reduce(L, orders, algo, wire_dtype=wire_dtype),
                           group=group)


def chain_all_to_all(
    x: torch.Tensor,
    order: Sequence[int] | None = None,
    *,
    wire_dtype: str | None = None,
    group=None,
) -> torch.Tensor:
    """Ring all-to-all: ``x[s, d]`` is the chunk row ``s`` sends to
    device ``d``; returns ``out[d, s] = x[s, d]``."""
    L = _axis(x, group)
    prog = prg.plan_all_to_all(L, (_ring_args(L, order),), wire_dtype=wire_dtype)
    return execute_program(x, prog, group=group)


def multi_chain_all_to_all(
    x: torch.Tensor,
    orders: Sequence[Sequence[int]],
    *,
    wire_dtype: str | None = None,
    group=None,
) -> torch.Tensor:
    """All-to-all over K disjoint equal-size sub-rings."""
    L = _axis(x, group)
    orders = tuple(validate_ring_partition(L, orders))
    return execute_program(x, prg.plan_all_to_all(L, orders, wire_dtype=wire_dtype),
                           group=group)


# ---------------------------------------------------------------------------
# The fabric-native baseline
# ---------------------------------------------------------------------------


def xla_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Broadcast baseline (the JAX package's fabric ``psum`` of the
    root's row): every row ends with row ``root``."""
    return x[root].unsqueeze(0).expand_as(x).clone()
