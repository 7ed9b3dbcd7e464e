"""Chainwrite collectives one rank per process: the ChainProgram executor
on ``torch.distributed`` — the port's counterpart of the JAX package's
``shard_map`` execution (``repro.core.chainwrite``'s ``_fanout``,
``_hop``, ``_one_step``, ``_run_stepped`` and ``_execute_pipeline``).

Each process is one device of the program: group rank ``d`` of the
``torch.distributed`` group is the program's device ``d``, and ``x`` is
that rank's own view, as JAX's ``execute_program`` takes it inside
``shard_map``: the whole payload for ``broadcast``, ``(L, ...)`` chunk
trains for ``reduce_scatter`` and ``all_to_all``, a flat payload for
``all_reduce``. :func:`execute_program` returns what JAX's returns on
that device. The stacked executor (``core.chainwrite``) runs the same
programs on every rank's row of one tensor; the two agree bit for bit.

* A step is load -> hop -> combine -> write (``core.program``'s machine
  model) on this rank's row of each addressing table, dense or
  symbolic, resolved once per (program, device, rank) with
  ``program.resolve_row``.
* A hop posts one ``isend`` for each of the step's edges whose source is
  this rank and one ``irecv`` if an edge targets it (``validate()``
  allows at most one), all in one ``batch_isend_irecv``, and waits for
  them; a rank that no edge targets gets zeros. A rank with nothing to
  send or receive in a step posts nothing.
* The int8 wire sends two messages per edge, the int8 frame and its f32
  scale (``quantize_rows`` on a 1-row view, so the bits are the stacked
  executor's row), and the destination dequantizes.
* The combine is the oracle's ``buf + rows(...)`` and the ADD write
  ``out + buf``, elementwise: no ``index_add_``, no reduction over a
  dim.
* The frame-pipelined broadcast sends only real frames: on slot ``t``
  the member at chain position ``p`` (the head is 0) sends frame
  ``t - p`` and receives frame ``t - p + 1``, while those lie in
  ``[0, F)``. The stacked scan's idle edge slots model the HLO; no
  process sends them.

Transport. The group's backend decides how a frame travels: NCCL sends
the device tensors themselves; gloo sends host tensors, so a CUDA
tensor on a gloo group is copied into a pinned host buffer before its
send, and each received frame back onto the card after its receive,
every time (:func:`transport` names it: ``"gloo via pinned host"``).
That is the transport the backend implies, not a fallback: a failure
raises. An NCCL group's first ``batch_isend_irecv`` must be joined by
every rank of the group, and a step that leaves a rank out (a
broadcast's non-members, a rank with nothing to send or receive) is
not: run one collective over an NCCL group before its first program
(``launch.mesh.ProcessMesh`` does, for each of its groups).

:data:`wire_counter` counts the bytes this process put on the wire:
each message as it is posted (an int8 edge: its frame and its 4-byte
scale). :func:`sent_wire_bytes` is that count's model. A ring program's
every device sends on every step, so a rank's count equals
``program_wire_bytes``; a broadcast's count summed over the ranks equals
the edges times the frame bytes — ``(members - 1) x payload`` for a
pipelined chain broadcast, whatever ``num_frames`` is: each byte crosses
each link once.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.runtime.compression import dequantize_rows, quantize_rows

from . import program as prg
from .program import ChainProgram

__all__ = [
    "WireCounter",
    "all_reduce_sum",
    "execute_program",
    "gather_rows",
    "group_rank",
    "group_size",
    "interpret_program",
    "sent_wire_bytes",
    "transport",
    "wire_counter",
]


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def transport(group, device: torch.device) -> str:
    """How a frame on ``device`` travels over ``group``: ``"nccl"``,
    ``"gloo"`` (host tensors) or ``"gloo via pinned host"`` (CUDA
    tensors staged through pinned host buffers)."""
    backend = str(dist.get_backend(group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo via pinned host"
    return backend


def sent_wire_bytes(
    prog: ChainProgram, size_bytes: int, num_frames: int = 1, rank: int | None = None
) -> int:
    """Bytes the process form puts on the wire running ``prog`` at a
    per-device payload of ``size_bytes``: rank ``rank``'s sends, or every
    rank's when ``rank`` is None. A step's edge carries
    ``prog.step_bytes``; in a frame-pipelined broadcast (``num_frames >
    1``) every edge carries the ``num_frames`` frames of ``size_bytes /
    num_frames`` once. ``program_wire_bytes`` is the HLO attribution
    instead (``Step.num_permutes`` x frame: the head's fan-out priced
    per extra permute, the pipelined scan's idle slots included)."""
    pipelined = prog.kind == "pipeline" and num_frames > 1 and bool(prog.steps)
    total = 0
    for s in prog.steps:
        edges = sum(1 for a, _ in s.edges if rank is None or a == rank)
        if pipelined:
            total += edges * num_frames * -(-size_bytes // num_frames)
        else:
            total += edges * prog.step_bytes(s, size_bytes)
    return total


class WireCounter:
    """Bytes this process put on the wire, and the programs it ran.

    ``bytes`` adds each message as it is posted; ``runs`` counts
    the calls of :func:`execute_program` per ``(program, per-device
    payload bytes, num_frames, group rank)``. :meth:`modeled_bytes`
    prices those runs with :func:`sent_wire_bytes` (always equal to
    ``bytes``) and :meth:`program_bytes` with the IR's HLO attribution
    (``program.pipelined_wire_bytes``; equal to ``bytes`` when every
    program run was a ring)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.bytes = 0
        self.runs: Counter[tuple[ChainProgram, int, int, int]] = Counter()

    def record(self, prog: ChainProgram, size: int, num_frames: int, rank: int) -> None:
        self.runs[prog, size, num_frames, rank] += 1

    def modeled_bytes(self) -> int:
        return sum(n * sent_wire_bytes(p, size, frames, rank)
                   for (p, size, frames, rank), n in self.runs.items())

    def program_bytes(self) -> int:
        return sum(n * prg.pipelined_wire_bytes(p, size, frames)
                   for (p, size, frames, _), n in self.runs.items())


wire_counter = WireCounter()


# ---------------------------------------------------------------------------
# Point-to-point exchange
# ---------------------------------------------------------------------------


def _exchange(group, sends, recvs) -> None:
    """Post every send ``(tensor, group peer, tag)`` and receive
    ``(buffer, group peer, tag)`` of one step in one
    ``batch_isend_irecv`` and wait for all of them. On a gloo group a
    CUDA tensor travels through a pinned host copy; received frames are
    copied into their buffers."""
    if not sends and not recvs:
        return
    stage = str(dist.get_backend(group)) == "gloo"

    def wire(t):
        t = t.contiguous()
        if stage and t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        return t

    ops, landed = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, wire(t), dist.get_global_rank(group, peer),
                              group, tag))
    for buf, peer, tag in recvs:
        w = buf
        if stage and buf.is_cuda:
            w = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        elif not buf.is_contiguous():
            w = torch.empty_like(buf, memory_format=torch.contiguous_format)
        if w is not buf:
            landed.append((buf, w))
        ops.append(dist.P2POp(dist.irecv, w, dist.get_global_rank(group, peer), group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for buf, w in landed:
        buf.copy_(w)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group`` (the backend's own
    all-reduce: a small tensor such as a step's metrics; a CUDA tensor on
    a gloo group goes through the host)."""
    if str(dist.get_backend(group)) == "gloo" and x.is_cuda:
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, group, dst: int = 0) -> torch.Tensor | None:
    """Every rank's ``x`` stacked along a new dim 0 (group rank order) on
    group rank ``dst``, which returns it; the others send theirs and
    return None. Point to point, on the group's transport."""
    rank, L = group_rank(group), group_size(group)
    if rank != dst:
        _exchange(group, [(x, dst, 0)], [])
        return None
    out = x.new_empty((L,) + tuple(x.shape))
    out[rank] = x
    _exchange(group, [], [(out[r], r, 0) for r in range(L) if r != rank])
    return out


# ---------------------------------------------------------------------------
# This rank's addressing, resolved once per (program, device, rank)
# ---------------------------------------------------------------------------


class _Row:
    """This rank's row of a table: gather indices, the live mask, and
    whether every entry is live / none is."""

    __slots__ = ("width", "idx", "mask", "full", "empty")

    def __init__(self, row, device) -> None:
        t = torch.tensor(row, dtype=torch.int64)
        live = t >= 0
        self.width = len(row)
        self.full = bool(live.all())
        self.empty = not bool(live.any())
        self.idx = t.clamp(min=0).to(device)
        self.mask = live.to(device)


class _Write:
    """This rank's write row: ``out[dst] (op)= buf[src]`` over the live
    entries (distinct slots, as ``validate()`` proves)."""

    __slots__ = ("src", "dst", "n", "every_row")

    def __init__(self, row, device) -> None:
        src = [j for j, s in enumerate(row) if s >= 0]
        self.n = len(src)
        self.every_row = src == list(range(len(row)))
        self.src = torch.tensor(src, dtype=torch.int64, device=device)
        self.dst = torch.tensor([row[j] for j in src], dtype=torch.int64, device=device)


class _Hop:
    """This rank's side of one step's edges: the group ranks it sends
    to, and the one it receives from (None: it receives zeros)."""

    __slots__ = ("dsts", "src")

    def __init__(self, edges, rank: int) -> None:
        self.dsts = [b for a, b in edges if a == rank]
        srcs = [a for a, b in edges if b == rank]
        if len(srcs) > 1:
            raise ValueError(f"device {rank} receives {len(srcs)} frames in one step")
        self.src = srcs[0] if srcs else None


def _cache(prog: ChainProgram, device: torch.device, rank: int) -> dict:
    """Per-(program, device, rank) cache, kept on the program object as
    the stacked executor keeps its tables."""
    cache = prog.__dict__.get("_torch_dist_tables")
    if cache is None:
        cache = {}
        object.__setattr__(prog, "_torch_dist_tables", cache)
    return cache.setdefault((str(device), rank), {})


def _resolved(prog, kind: str, obj, device, rank: int, make):
    cache = _cache(prog, device, rank)
    key = (kind, id(obj))
    hit = cache.get(key)
    if hit is None or hit[0] is not obj:
        hit = (obj, make())
        cache[key] = hit
    return hit[1]


def _row(prog, table, device, rank) -> _Row:
    return _resolved(prog, "row", table, device, rank,
                     lambda: _Row(prg.resolve_row(prog, table, rank), device))


def _rows(prog, table, rank, source: torch.Tensor, keep: torch.Tensor | None = None):
    """``result[j] = source[row[j]]``; ``-1`` gives ``keep[j]`` (same
    width) or zeros — the oracle's ``rows`` on this rank's row."""
    r = _row(prog, table, source.device, rank)
    if r.empty:
        if keep is not None and keep.shape[0] == r.width:
            return keep
        return source.new_zeros((r.width,) + tuple(source.shape[1:]))
    got = source.index_select(0, r.idx)
    if r.full:
        return got
    mask = r.mask.reshape((-1,) + (1,) * (got.dim() - 1))
    if keep is not None and keep.shape[0] == r.width:
        return torch.where(mask, got, keep)
    return torch.where(mask, got, got.new_zeros(()))


def _hop(prog, step, rank, group, buf: torch.Tensor, wire: str | None) -> torch.Tensor:
    """Ship ``buf`` over this rank's edges of ``step``; returns what
    arrives (zeros when nothing targets this rank). Counts the bytes
    this rank sends."""
    h = _resolved(prog, "hop", step.edges, buf.device, rank, lambda: _Hop(step.edges, rank))
    frames = []
    if h.dsts and wire == "int8":
        q, scale = quantize_rows(buf[None])
        frames = [(q[0], 0), (scale, 1)]
    elif h.dsts:
        frames = [(buf, 0)]
    sends = [(t, b, tag) for b in h.dsts for t, tag in frames]
    recvs = []
    if h.src is not None:
        if wire == "int8":
            recvs = [(torch.empty(buf.shape, dtype=torch.int8, device=buf.device), h.src, 0),
                     (torch.empty((1,), dtype=torch.float32, device=buf.device), h.src, 1)]
        else:
            recvs = [(torch.empty_like(buf), h.src, 0)]
    wire_counter.bytes += sum(t.numel() * t.element_size() for t, _, _ in sends)
    _exchange(group, sends, recvs)
    if h.src is None:
        return torch.zeros_like(buf)
    if wire == "int8":
        return dequantize_rows(recvs[0][0][None], recvs[1][0])[0]
    return recvs[0][0]


def _write(prog, step, rank, buf: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    w = _resolved(prog, "write", step, buf.device, rank,
                  lambda: _Write(prg.resolve_row(prog, step.write, rank), buf.device))
    if w.n == 0:
        return out
    vals = buf if w.every_row else buf.index_select(0, w.src)
    if step.write_op != prg.COPY:
        vals = out.index_select(0, w.dst).add_(vals)  # the oracle's out + buf
    out.index_copy_(0, w.dst, vals)
    return out


def interpret_program(shards: torch.Tensor, prog: ChainProgram, group) -> torch.Tensor:
    """Run ``prog`` on this rank's pre-blocked input ``shards``
    (``(addr_shards, m, ...)``); returns its out slots ``(out_slots, m,
    ...)`` — the per-rank twin of ``chainwrite.interpret_program``, step
    for step (load, hop, combine, write)."""
    rank = group_rank(group)
    if shards.dim() < 1 or shards.shape[0] != prog.addr_shards:
        raise ValueError(f"shards {tuple(shards.shape)} incompatible with program "
                         f"(addr_shards={prog.addr_shards})")
    wires = [prog.step_wire_dtype(s) for s in prog.steps]
    orig_dtype = shards.dtype
    if any(w is not None for w in wires):
        if not shards.is_floating_point():
            raise ValueError(
                f"wire_dtype='int8' requires a floating payload, got {shards.dtype}")
        shards = shards.to(torch.float32)
    buf = _rows(prog, prog.buf_init, rank, shards)
    out = _rows(prog, prog.out_init, rank, shards)  # a fresh tensor: written in place
    for step, wire in zip(prog.steps, wires):
        if step.load is not None:
            buf = _rows(prog, step.load, rank, out, keep=buf)
        buf = _hop(prog, step, rank, group, buf, wire)
        if step.combine == prg.ADD:
            src = shards if step.add_from == "input" else out
            buf = buf.add_(_rows(prog, step.add_src, rank, src))  # a fresh hop result
        if step.write is not None:
            out = _write(prog, step, rank, buf, out)
    return out.to(orig_dtype)


def _positions(prog: ChainProgram) -> list[int]:
    """Chain position of every device: 0 for the head, ``p`` for the
    receiver of step ``p - 1``, ``len(steps) + 1`` for non-members."""
    pos = [len(prog.steps) + 1] * prog.num_devices
    pos[int(prog.head)] = 0
    for t, step in enumerate(prog.steps):
        for _, dst in step.edges:
            pos[dst] = t + 1
    return pos


def _execute_pipeline(x: torch.Tensor, prog: ChainProgram, num_frames: int, group,
                      rank: int) -> torch.Tensor:
    """Broadcast programs: the stepped interpreter for a single frame, or
    the store-and-forward frame pipeline over F + L - 2 slots, each edge
    sending only the frames that are on it."""
    if num_frames <= 1 or not prog.steps:
        return interpret_program(x[None], prog, group)[0]
    if x.shape[0] % num_frames != 0:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by num_frames={num_frames}")
    cache = _cache(prog, x.device, rank)
    if "pipeline" not in cache:
        edges = [e for s in prog.steps for e in s.edges]
        cache["pipeline"] = (_positions(prog)[rank], [b for a, b in edges if a == rank],
                             _Hop(edges, rank).src)
    pos, dsts, src = cache["pipeline"]
    frames = x.reshape((num_frames, x.shape[0] // num_frames) + tuple(x.shape[1:]))
    out = frames.clone() if rank == int(prog.head) else x.new_zeros(frames.shape)
    for t in range(num_frames + len(prog.steps) - 1):
        f = t - pos  # the frame this rank sends on slot t; it receives f + 1
        sends = [(out[f], b, 0) for b in dsts] if 0 <= f < num_frames else []
        recvs = [(out[f + 1], src, 0)] if src is not None and 0 <= f + 1 < num_frames else []
        wire_counter.bytes += sum(s.numel() * s.element_size() for s, _, _ in sends)
        _exchange(group, sends, recvs)
    return out.reshape(x.shape)


def execute_program(
    x: torch.Tensor, prog: ChainProgram, *, group, num_frames: int = 1, tiled: bool = False
) -> torch.Tensor:
    """Run a :class:`ChainProgram` on this rank's view ``x`` over
    ``group`` (group rank ``d`` = the program's device ``d``), with JAX's
    per-device blocking and assembly: ``broadcast`` takes and returns the
    whole payload (``num_frames`` pipelines it; non-members return
    zeros); ``all_gather`` stacks (or, ``tiled``, concatenates) the
    ranks' payloads in rank order; ``reduce_scatter``/``all_to_all``
    take ``(L, ...)`` chunk trains; ``all_reduce`` zero-pads the leading
    dim to the program's shard count and unpads on the way out."""
    L = prog.num_devices
    if group_size(group) != L:
        raise ValueError(f"program planned for {L} devices, group has {group_size(group)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"execute_program: unsupported device {x.device}")
    rank = group_rank(group)
    c = prog.collective
    # per-device payload bytes; an int8 wire computes in f32
    compressed = any(prog.step_wire_dtype(s) is not None for s in prog.steps)
    elem = 4 if compressed else x.element_size()
    size = x.numel() * elem
    if c == "broadcast":
        wire_counter.record(prog, size, max(1, num_frames), rank)
        return _execute_pipeline(x, prog, num_frames, group, rank)
    if c == "all_gather":
        wire_counter.record(prog, size, 1, rank)
        out = interpret_program(x[None], prog, group)
        if tiled:
            out = out.reshape((L * x.shape[0],) + tuple(x.shape[1:]))
        return out
    if c in ("reduce_scatter", "all_to_all"):
        if x.dim() < 1 or x.shape[0] != L:
            raise ValueError(f"leading dim {x.shape[0] if x.dim() else 0} != axis size {L}")
        wire_counter.record(prog, size, 1, rank)
        out = interpret_program(x, prog, group)
        return out[0] if c == "reduce_scatter" else out
    if c == "all_reduce":
        S = prog.addr_shards
        lead = x.shape[0]
        pad = (-lead) % S
        if pad:
            xp = x.new_zeros((lead + pad,) + tuple(x.shape[1:]))
            xp[:lead] = x
        else:
            xp = x
        wire_counter.record(prog, xp.numel() * elem, 1, rank)
        out = interpret_program(xp.reshape((S, xp.shape[0] // S) + tuple(x.shape[1:])),
                                prog, group)
        if prog.out_slots == 1:  # rotation: whole payload in one slot
            full = out[0]
        else:
            full = out.reshape((out.shape[0] * out.shape[1],) + tuple(x.shape[1:]))
        return full[:lead] if pad else full
    raise ValueError(f"unknown collective {c!r}")
