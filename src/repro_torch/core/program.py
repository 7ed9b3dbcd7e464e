"""ChainProgram: the single schedule IR behind every Torrent collective.

The paper's core claim is that every P2MP pattern is *just a schedule*
of P2P hops over an unmodified NoC. This module makes that literal: a
:class:`ChainProgram` is an ordered list of :class:`Step`\\ s, each step
a set of ``(src, dst)`` edges plus per-device shard-addressing tables,
generated once by the ``plan_*`` functions from a chain/ring partition.
Three interchangeable backends consume the same program:

* the SPMD executor (``chainwrite.execute_program`` — fused ppermutes),
* the numpy interpreter (``chainwrite_ref.interpret_program`` — the
  bit-exactness oracle),
* the cycle/byte models (``simulator.program_latency`` /
  ``simulator.program_wire_bytes``).

Machine model (identical in every backend). Each device ``d`` holds:

* ``shards`` — its local input viewed as ``(addr_shards, m, ...)``
  (``addr_shards == 1`` means the whole payload is one frame);
* ``buf``   — the transit register: ``(width, m, ...)`` where ``width``
  is per-step (a step may carry a multi-shard block);
* ``out``   — ``(out_slots, m, ...)`` result/accumulator slots.

Per step, in order:

1. *load*    — ``buf[j] = out[load[d][j]]`` (``-1`` keeps the current
   row; required in full whenever the width changes);
2. *hop*     — ``buf = permute(buf, edges)``: ``dst`` receives ``src``'s
   buffer, devices no edge targets receive zeros;
3. *combine* — ``combine == "add"``: ``buf[j] += source[add_src[d][j]]``
   where ``source`` is the input shards (``add_from == "input"``) or the
   out slots (``add_from == "out"``); ``-1`` adds nothing;
4. *write*   — ``out[write[d][j]] (op)= buf[j]`` with ``write_op`` in
   ``{"copy", "add"}``; ``-1`` discards the row.

IR invariants (enforced by :meth:`ChainProgram.validate`, pinned by the
device-free golden-schedule tests):

* **edge-disjointness within a step** — a device receives at most one
  frame per step (unique destinations always; unique sources too for
  ``kind == "stepped"`` programs, so every step is ONE fused ppermute;
  ``kind == "pipeline"`` may repeat the head as a source — the
  executor splits the extra fan-out sends into their own permutes,
  which :func:`program_wire_bytes` accounts via
  :meth:`Step.num_permutes`);
* **shard-fraction accounting** — every step moves
  ``width / addr_shards`` of the payload per edge
  (:meth:`ChainProgram.step_bytes`); all addressing tables index within
  ``addr_shards`` / ``out_slots`` bounds, and a device's write rows
  target distinct slots;
* **combine-op semantics** — ``"copy"`` steps move data unchanged;
  ``"add"`` steps fold exactly one addressed local shard into each buf
  row *after* the hop (left-fold: ``buf + shard``), so replaying the
  program fixes the floating-point reduction order and any two
  backends agree BIT-exactly.

Symbolic addressing (the contract every backend shares). A "table" in
this IR is EITHER a dense ``tuple``-of-rows (``(num_devices, width)``,
``-1`` = none — the escape hatch for irregular schedules and hand-built
programs) OR one of four compact address *generators* evaluated per
device from its ring position — the IR analogue of XDMA's hardware
address generators:

* :class:`Affine`        — ``row[col] = (a·pos + c·ring + e·col + b)
  mod m`` for ring members, ``-1`` for non-members (constants, ring-
  position shards, iota rows);
* :class:`MemberLookup`  — ``row[col] = orders[(ar·ring + er·col + br)
  mod K][(ap·pos + ep·col + bp) mod S]`` (device-id addressing through
  the ring member map);
* :class:`Diag`          — ``row[d] = inner(d)`` on device ``d``'s own
  column, ``-1`` elsewhere (the all_to_all peel);
* :class:`AtDevices`     — ``row = [value]·width`` on a listed device
  set, ``-1`` elsewhere (chain heads and per-step chain writes).

Planning therefore builds O(1)-sized tables per step (O(L) per program
including the shared edge lists); ``validate()`` checks symbolic
tables structurally (coefficients and bounds, no materialization); the
numpy oracle materializes rows lazily via :func:`resolve_table` /
:func:`resolve_row`; and the SPMD executor evaluates the coefficients
in-kernel from ``lax.axis_index`` — on a *canonical* ring partition
(``groups[j] == range(j·S, (j+1)·S)`` covering the axis) its compiled
HLO carries NO ring-length-dependent constants.

Planners (``orders``/``chains`` are the scheduled partitions from
``core.scheduling``; ``num_devices`` is the SPMD axis size or the NoC
node count):

* :func:`plan_broadcast`       — P2MP multicast down K disjoint chains
  (``kind="pipeline"``: the data phase streams, frames optional);
* :func:`plan_recovery`        — the endpoint-side failure recovery of
  a multi-chain broadcast as a program: one detection-window step
  (``tag="detect"``, no edges) plus the re-formed orphaned suffix of
  every affected sub-chain as ordered chain steps, each suffix
  streaming from the surviving member that banked the payload
  (``group_heads``); concurrent failures in distinct sub-chains share
  the steps (and the initiator's cfg port, in the latency model);
* :func:`plan_all_gather`      — per-ring all-gather, then a cross-ring
  block exchange for K > 1;
* :func:`plan_reduce_scatter`  — per-ring reduce-scatter over K-chunk
  groups, then a cross-ring group reduce-scatter for K > 1;
* :func:`plan_all_reduce`      — ``algo="rs_ag"`` (fused per-ring RS →
  cross-ring shard rotation → fused per-ring AG, shards addressed by
  ring position) or ``algo="rotation"`` (full-payload rotations); K=1
  is the single-ring RS+AG with *device-id* chunk addressing (the
  historical ``chain_all_reduce`` schedule);
* :func:`plan_all_to_all`      — the rotating chunk train; K > 1
  interleaves intra-ring rotations with cross-ring hops (same total
  wire, shorter per-step distances).

Every :class:`Step` (and the program as a default) carries a
``wire_dtype``: ``None`` ships frames in the payload dtype; ``"int8"``
quantizes each hop's frame to int8 with one f32 scale riding alongside
(per-hop quantize → ship → dequantize → f32 combine). Compression is
therefore an ordinary IR dimension — the same executor, oracle replay,
byte/latency accounting and (K, algo, wire_dtype) selection apply.

This module is dependency-light (stdlib only) so the SPMD layer, the
numpy oracle, the simulator and the CLI all share ONE schedule source.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, Iterator, Sequence

# Canonical multi-ring all-reduce schedule names — the single tuple the
# SPMD layer, the simulator and the CLI validate against.
ALL_REDUCE_ALGOS = ("rs_ag", "rotation")

# Wire dtypes a step may ship. None = payload dtype unchanged; "int8" =
# per-hop symmetric quantization: an int8 frame plus one f32 scale.
WIRE_DTYPES = ("int8",)
_WIRE_SCALE_BYTES = 4  # the f32 scale shipped alongside each int8 frame


def normalize_wire_dtype(wire_dtype) -> str | None:
    """Canonical IR form of a wire dtype: ``None`` (ship the payload
    dtype) or a name from :data:`WIRE_DTYPES`. Accepts the string form
    or any numpy/jax dtype object whose name matches — keeping this
    module stdlib-only while letting callers pass ``jnp.int8``."""
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, str):
        name = wire_dtype
    else:
        name = (
            getattr(wire_dtype, "__name__", None)
            or getattr(wire_dtype, "name", None)
            or str(wire_dtype)
        )
    if name not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire dtype {wire_dtype!r}; "
            f"expected None or one of {WIRE_DTYPES}"
        )
    return name


Edge = tuple[int, int]
Table = tuple[tuple[int, ...], ...]  # (num_devices, width); -1 = none

COPY = "copy"
ADD = "add"


def _table(rows: Sequence[Sequence[int]]) -> Table:
    return tuple(tuple(int(v) for v in row) for row in rows)


# ---------------------------------------------------------------------------
# Symbolic addressing tables (see module docstring for the contract)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Affine:
    """``row[col] = (a·pos + c·ring + e·col + b) mod m`` for ring
    members; all ``-1`` for devices outside every group."""

    width: int
    a: int = 0  # coefficient on ring position
    c: int = 0  # coefficient on ring index
    e: int = 0  # coefficient on column
    b: int = 0  # offset
    m: int = 1  # modulus (values live in [0, m))


@dataclasses.dataclass(frozen=True)
class MemberLookup:
    """``row[col] = orders[(ar·ring + er·col + br) mod K]
    [(ap·pos + ep·col + bp) mod S]`` — device-id addressing through the
    ring member map; all ``-1`` for non-members."""

    width: int
    ar: int = 0
    er: int = 0
    br: int = 0
    ap: int = 0
    ep: int = 0
    bp: int = 0


@dataclasses.dataclass(frozen=True)
class Diag:
    """``row[d] = inner(d)`` on device ``d``'s own column (width must be
    ``num_devices``), ``-1`` elsewhere — the all_to_all peel/out_init
    shape. ``inner`` is a width-1 :class:`Affine` or
    :class:`MemberLookup` evaluated at column 0."""

    width: int
    inner: "Affine | MemberLookup"


@dataclasses.dataclass(frozen=True)
class AtDevices:
    """``row = (value,)·width`` on the listed devices, all ``-1``
    elsewhere — chain heads (inits/loads) and per-step chain writes.
    ``devices=()`` is the all-none table."""

    devices: tuple[int, ...]
    value: int = 0
    width: int = 1


# Any table position accepts the dense tuple form or a symbolic map.
TableRef = Table | Affine | MemberLookup | Diag | AtDevices


class _RingCtx:
    """Host-side ring-partition context for symbolic resolution: member
    orders, per-device position/ring index, and whether the partition
    is *canonical* (``orders[j] == range(j·S, (j+1)·S)`` covering the
    axis — the executor then derives pos/ring arithmetically from the
    device index, with zero L-sized HLO constants)."""

    __slots__ = ("orders", "K", "S", "pos", "ring_of", "canonical",
                 "max_member")

    def __init__(self, num_devices: int, orders) -> None:
        orders = tuple(tuple(int(d) for d in c) for c in orders)
        if not orders or not orders[0]:
            raise ValueError("symbolic table needs non-empty ring groups")
        S = len(orders[0])
        if any(len(c) != S for c in orders):
            raise ValueError("symbolic table needs equal-size ring groups")
        self.orders = orders
        self.K, self.S = len(orders), S
        self.pos: dict[int, int] = {}
        self.ring_of: dict[int, int] = {}
        for j, ring in enumerate(orders):
            for p, d in enumerate(ring):
                self.pos[d] = p
                self.ring_of[d] = j
        self.max_member = max(self.pos)
        self.canonical = self.K * S == num_devices and all(
            orders[j][p] == j * S + p
            for j in range(self.K)
            for p in range(S)
        )


def table_width(table) -> int:
    """Column count of a dense or symbolic table."""
    if isinstance(table, tuple):
        return len(table[0]) if table else 0
    return table.width


def _scalar_eval(inner, ctx: _RingCtx, d: int) -> int:
    """Column-0 value of a width-1 Affine/MemberLookup on device ``d``."""
    if d not in ctx.pos:
        return -1
    p, r = ctx.pos[d], ctx.ring_of[d]
    if isinstance(inner, Affine):
        return (inner.a * p + inner.c * r + inner.b) % inner.m
    return ctx.orders[(inner.ar * r + inner.br) % ctx.K][
        (inner.ap * p + inner.bp) % ctx.S
    ]


def resolve_row(program: "ChainProgram", table, d: int) -> tuple[int, ...]:
    """Materialize ONE device's row of a dense or symbolic table —
    O(width), so golden-schedule tests spot-check 1024-ring programs
    without building (L, L) tables."""
    if isinstance(table, tuple):
        return table[d]
    if isinstance(table, AtDevices):
        w = table.width
        return (table.value,) * w if d in table.devices else (-1,) * w
    ctx = program.ring_ctx()
    if isinstance(table, Diag):
        row = [-1] * table.width
        row[d] = _scalar_eval(table.inner, ctx, d)
        return tuple(row)
    if d not in ctx.pos:
        return (-1,) * table.width
    p, r = ctx.pos[d], ctx.ring_of[d]
    if isinstance(table, Affine):
        return tuple(
            (table.a * p + table.c * r + table.e * col + table.b) % table.m
            for col in range(table.width)
        )
    if isinstance(table, MemberLookup):
        return tuple(
            ctx.orders[(table.ar * r + table.er * col + table.br) % ctx.K][
                (table.ap * p + table.ep * col + table.bp) % ctx.S
            ]
            for col in range(table.width)
        )
    raise TypeError(f"unknown table type {type(table).__name__}")


def resolve_table(program: "ChainProgram", table) -> Table:
    """Materialize a dense or symbolic table to the dense tuple form —
    the numpy oracle's lazy path (dense tables pass through)."""
    if isinstance(table, tuple):
        return table
    return tuple(
        resolve_row(program, table, d) for d in range(program.num_devices)
    )


@dataclasses.dataclass(frozen=True)
class Step:
    """One schedule step: a set of concurrent P2P hops + addressing."""

    edges: tuple[Edge, ...]
    width: int = 1
    combine: str = COPY  # buf update after the hop: copy | add
    add_from: str = "input"  # add reads "input" shards or "out" slots
    add_src: TableRef | None = None
    load: TableRef | None = None  # out slots loaded into buf BEFORE the hop
    write: TableRef | None = None  # out slot written per buf row after combine
    write_op: str = COPY  # copy | add
    # Latency-model grouping: "intra" | "cross" (ring rounds), "chain"
    # (pipeline hop slots), "detect" (edge-free failure-timeout window —
    # priced as SimParams.fail_timeout_cc per occurrence, zero bytes).
    tag: str = "intra"
    # Per-step wire dtype override; None defers to the program default.
    wire_dtype: str | None = None

    def num_permutes(self) -> int:
        """ppermute ops the SPMD executor emits for this step: one fused
        permute for the unique-source edge set, plus one extra permute
        per repeated source (the pipeline head's same-step fan-out).
        Memoized per instance (fields are frozen) so 1024-ring byte
        accounting does not rescan the shared edge lists."""
        cached = self.__dict__.get("_num_permutes")
        if cached is not None:
            return cached
        if not self.edges:
            n = 0
        else:
            counts: dict[int, int] = {}
            for src, _ in self.edges:
                counts[src] = counts.get(src, 0) + 1
            n = 1 + sum(c - 1 for c in counts.values())
        object.__setattr__(self, "_num_permutes", n)
        return n

    def __getstate__(self):
        # Exclude memo attrs: pickled size must reflect the IR alone.
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def __setstate__(self, state):
        for k, v in state.items():
            object.__setattr__(self, k, v)


@dataclasses.dataclass(frozen=True)
class ChainProgram:
    """A complete collective schedule (see module docstring)."""

    collective: str  # broadcast | all_gather | reduce_scatter | ...
    kind: str  # "pipeline" (streamed chains) | "stepped" (ring rounds)
    num_devices: int
    addr_shards: int  # input viewed as (addr_shards, m, ...)
    out_slots: int
    buf_init: Table  # (L, width0) input-shard indices; -1 = zeros
    out_init: Table  # (L, out_slots) input-shard indices; -1 = zeros
    steps: tuple[Step, ...]
    # Schedule metadata for the latency model: for kind="pipeline" the
    # per-chain destination orders (head excluded) + head; for
    # kind="stepped" the K sub-rings (full member orders).
    groups: tuple[tuple[int, ...], ...]
    head: int | None = None
    algo: str | None = None
    # Per-group data-entry nodes for kind="pipeline" programs whose
    # streams do NOT all start at the cfg initiator (recovery: each
    # re-formed suffix streams from the member that banked the payload).
    # None = every group streams from the initiator.
    group_heads: tuple[int, ...] | None = None
    # Program-default wire dtype (``Step.wire_dtype`` overrides per
    # step); None = frames ship in the payload dtype.
    wire_dtype: str | None = None

    # -- symbolic resolution ------------------------------------------
    def ring_ctx(self) -> _RingCtx:
        """The ring-partition context symbolic tables evaluate against
        (``groups`` interpreted as the K equal-size member orders).
        Cached per instance; never part of equality/pickling."""
        ctx = self.__dict__.get("_ring_ctx")
        if ctx is None:
            ctx = _RingCtx(self.num_devices, self.groups)
            object.__setattr__(self, "_ring_ctx", ctx)
        return ctx

    def with_wire_dtype(self, wire_dtype) -> "ChainProgram":
        """This program with a different default wire dtype — an O(1)
        field replacement (steps and tables are shared), so candidate
        scoring can derive every wire variant from ONE planned base."""
        wd = normalize_wire_dtype(wire_dtype)
        if wd == self.wire_dtype:
            return self
        if wd is not None and self.kind != "stepped":
            raise ValueError(
                "wire_dtype is only supported on stepped programs "
                "(the frame-pipelined executor ships payload-dtype frames)"
            )
        return dataclasses.replace(self, wire_dtype=wd)

    def __getstate__(self):
        # Exclude the cached _RingCtx: pickled size reflects the IR.
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def __setstate__(self, state):
        for k, v in state.items():
            object.__setattr__(self, k, v)

    # -- accounting ---------------------------------------------------
    def step_wire_dtype(self, step: Step) -> str | None:
        """Resolved wire dtype of ``step``: its own override, else the
        program default; ``None`` = payload dtype."""
        return step.wire_dtype if step.wire_dtype is not None else self.wire_dtype

    def step_bytes(self, step: Step, size_bytes: int) -> int:
        """Frame bytes one edge of ``step`` carries, for a per-device
        input payload of ``size_bytes``. An int8-wire step ships a
        quarter-size frame (the byte model assumes a 4-byte payload
        dtype, matching the executor's f32 wire arithmetic) plus one
        f32 scale scalar per frame."""
        frame = step.width * _ceil_div(size_bytes, self.addr_shards)
        if self.step_wire_dtype(step) == "int8":
            return _ceil_div(frame, 4) + _WIRE_SCALE_BYTES
        return frame

    def wire_bytes(self, size_bytes: int) -> int:
        """Modeled collective wire bytes of the whole program — the
        trip-count-aware HLO ``collective-permute`` attribution: every
        emitted ppermute counts its (per-device) operand bytes. For
        ring ("stepped") programs every device sends each step, so this
        is also the per-device wire-byte total."""
        return sum(
            s.num_permutes() * self.step_bytes(s, size_bytes)
            for s in self.steps
        )

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def describe(self, size_bytes: int | None = None) -> Iterator[str]:
        """Human-readable step table (the examples/ demo)."""
        yield (
            f"{self.collective} [{self.kind}"
            + (f", algo={self.algo}" if self.algo else "")
            + (f", wire={self.wire_dtype}" if self.wire_dtype else "")
            + f"] devices={self.num_devices} shards=1/{self.addr_shards}"
            f" out_slots={self.out_slots} groups={list(self.groups)}"
        )
        for i, s in enumerate(self.steps):
            line = (
                f"  step {i:2d} [{s.tag:5s}] edges={len(s.edges)}"
                f" permutes={s.num_permutes()} frac={s.width}/{self.addr_shards}"
                f" combine={s.combine} {list(s.edges)}"
            )
            wd = self.step_wire_dtype(s)
            if wd is not None:
                line += f" wire={wd}"
            if size_bytes is not None:
                line += f" bytes/edge={self.step_bytes(s, size_bytes)}"
            yield line
        if size_bytes is not None:
            yield f"  total wire bytes: {self.wire_bytes(size_bytes)}"

    # -- validation ---------------------------------------------------
    def validate(self) -> "ChainProgram":
        L = self.num_devices
        if L < 1 or self.addr_shards < 1 or self.out_slots < 1:
            raise ValueError("degenerate program dimensions")
        if self.kind not in ("pipeline", "stepped"):
            raise ValueError(f"unknown program kind {self.kind!r}")
        if normalize_wire_dtype(self.wire_dtype) is not None and self.kind != "stepped":
            raise ValueError(
                "wire_dtype is only supported on stepped programs "
                "(the frame-pipelined executor ships payload-dtype frames)"
            )
        if self.group_heads is not None:
            if self.kind != "pipeline":
                raise ValueError("group_heads only applies to pipeline programs")
            if len(self.group_heads) != len(self.groups):
                raise ValueError(
                    f"group_heads has {len(self.group_heads)} entries, "
                    f"expected one per group ({len(self.groups)})"
                )
            for h in self.group_heads:
                if not 0 <= h < L:
                    raise ValueError(f"group head {h} out of range")
        self._check_table(self.buf_init, None, self.addr_shards, "buf_init")
        self._check_table(self.out_init, self.out_slots, self.addr_shards, "out_init")
        width = table_width(self.buf_init) or 1
        # Steps share their edge tuples (one intra + one cross list per
        # program), so the O(len(edges)) structural checks memoize by
        # object identity — validation stays O(L) for 1024-ring runs.
        edges_ok: set[int] = set()
        for i, s in enumerate(self.steps):
            if s.width < 1:
                raise ValueError(f"step {i}: width < 1")
            if normalize_wire_dtype(s.wire_dtype) is not None and self.kind != "stepped":
                raise ValueError(f"step {i}: wire_dtype on a {self.kind} program")
            if id(s.edges) not in edges_ok:
                dsts = [e[1] for e in s.edges]
                if len(set(dsts)) != len(dsts):
                    raise ValueError(f"step {i}: duplicate edge destinations")
                if self.kind == "stepped":
                    srcs = [e[0] for e in s.edges]
                    if len(set(srcs)) != len(srcs):
                        raise ValueError(f"step {i}: duplicate edge sources")
                for a, b in s.edges:
                    if not (0 <= a < L and 0 <= b < L):
                        raise ValueError(f"step {i}: edge ({a},{b}) out of range")
                edges_ok.add(id(s.edges))
            if s.width != width and s.load is None:
                raise ValueError(f"step {i}: width change without load")
            if s.load is not None:
                self._check_table(s.load, s.width, self.out_slots, f"step {i} load")
            if s.combine == ADD:
                bound = self.addr_shards if s.add_from == "input" else self.out_slots
                if s.add_src is None:
                    raise ValueError(f"step {i}: add without add_src")
                self._check_table(s.add_src, s.width, bound, f"step {i} add_src")
            elif s.combine != COPY:
                raise ValueError(f"step {i}: unknown combine {s.combine!r}")
            if s.write is not None:
                self._check_table(s.write, s.width, self.out_slots, f"step {i} write")
                self._check_write_distinct(s.write, i)
            width = s.width
        return self

    def _check_table(self, table, width, bound, name) -> None:
        if isinstance(table, tuple):
            if len(table) != self.num_devices:
                raise ValueError(f"{name}: table has {len(table)} rows, "
                                 f"expected {self.num_devices}")
            for row in table:
                if width is not None and len(row) != width:
                    raise ValueError(f"{name}: row width {len(row)} != {width}")
                for v in row:
                    if not (-1 <= v < bound):
                        raise ValueError(f"{name}: index {v} out of range {bound}")
            return
        # Symbolic tables: structural O(1) checks (the ring context is
        # built once per program, O(L)).
        if table.width < 1:
            raise ValueError(f"{name}: width < 1")
        if width is not None and table.width != width:
            raise ValueError(f"{name}: row width {table.width} != {width}")
        if isinstance(table, AtDevices):
            for dev in table.devices:
                if not 0 <= dev < self.num_devices:
                    raise ValueError(f"{name}: device {dev} out of range")
            if not -1 <= table.value < bound:
                raise ValueError(
                    f"{name}: index {table.value} out of range {bound}"
                )
            return
        if isinstance(table, Diag):
            if table.width != self.num_devices:
                raise ValueError(
                    f"{name}: Diag width {table.width} != num_devices"
                )
            self._check_table(table.inner, 1, bound, f"{name} inner")
            return
        if isinstance(table, Affine):
            if not 1 <= table.m <= bound:
                raise ValueError(
                    f"{name}: modulus {table.m} outside [1, {bound}]"
                )
            return
        if isinstance(table, MemberLookup):
            if self.ring_ctx().max_member >= bound:
                raise ValueError(
                    f"{name}: ring member {self.ring_ctx().max_member} "
                    f"out of range {bound}"
                )
            return
        raise TypeError(f"{name}: unknown table type {type(table).__name__}")

    def _check_write_distinct(self, table, i: int) -> None:
        """A device's write rows must target distinct out slots. Dense
        tables are checked row by row; symbolic ones structurally (the
        property test pins the materialized equivalence)."""
        if isinstance(table, tuple):
            for d, row in enumerate(table):
                live = [v for v in row if v >= 0]
                if len(set(live)) != len(live):
                    raise ValueError(
                        f"step {i}: device {d} writes one slot twice"
                    )
            return
        if isinstance(table, Diag) or table.width == 1:
            return  # at most one live slot per row
        if isinstance(table, AtDevices):
            if table.devices and table.value >= 0:
                raise ValueError(
                    f"step {i}: AtDevices write repeats slot {table.value}"
                )
            return
        if isinstance(table, Affine):
            if math.gcd(table.e, table.m) == 1 and table.width <= table.m:
                return
        elif isinstance(table, MemberLookup):
            K, S = self.ring_ctx().K, self.ring_ctx().S
            if table.ep % S == 0 and math.gcd(table.er, K) == 1 \
                    and table.width <= K:
                return  # distinct rings -> distinct members
            if table.er % K == 0 and math.gcd(table.ep, S) == 1 \
                    and table.width <= S:
                return  # one ring, distinct positions
        raise ValueError(
            f"step {i}: cannot prove distinct write slots for "
            f"{type(table).__name__}"
        )


def program_wire_bytes(program: ChainProgram, size_bytes: int) -> int:
    """Functional alias of :meth:`ChainProgram.wire_bytes`."""
    return program.wire_bytes(size_bytes)


def tier_crossing_stats(
    program: ChainProgram, topo, src: int = 0
) -> dict[str, object]:
    """Tier-crossing accounting of a planned program on a weighted
    topology (``topo`` is any object honouring the link-graph contract
    of :mod:`repro.core.topology` — duck-typed so this module stays
    stdlib-only).

    Returns ``{"per_group", "per_step", "crossing_steps", "total"}``:

    * ``per_group`` — for each chain/ring, how many consecutive-member
      route *segments* traverse at least one tier>0 (inter-pod) link
      (pipeline chains walk head -> members; stepped rings close the
      loop). The tier-aware partitioner targets ≤ 1 per chain.
    * ``per_step`` — for each stepped round, how many of its fused
      edges cross a pod boundary (pipeline programs have data-free
      steps here: ``0`` per step).
    * ``crossing_steps`` — number of steps with ≥ 1 crossing edge (the
      "one inter-pod exchange per shard" count of a hierarchical
      schedule).
    * ``total`` — summed tier>0 link traversals over the group routes
      (link granularity, wire-energy flavoured; the step edges are
      derived from the same routes, so they are not double-counted).
    """
    heads = program.group_heads or (src,) * len(program.groups)
    per_group: list[int] = []
    total = 0
    for order, head in zip(program.groups, heads):
        if not order:
            per_group.append(0)
            continue
        walk = [int(head)] + [int(d) for d in order]
        if program.kind != "pipeline" and len(order) > 1:
            walk = [int(d) for d in order] + [int(order[0])]  # closed ring
        segs = 0
        for a, b in zip(walk, walk[1:]):
            c = topo.path_tier_crossings(a, b)
            total += c
            if c:
                segs += 1
        per_group.append(segs)
    per_step: list[int] = []
    crossing_steps = 0
    for step in program.steps:
        n = sum(
            1
            for a, b in step.edges
            if topo.path_tier_crossings(int(a), int(b))
        )
        per_step.append(n)
        if n:
            crossing_steps += 1
    return {
        "per_group": per_group,
        "per_step": per_step,
        "crossing_steps": crossing_steps,
        "total": total,
    }


def pipelined_wire_bytes(
    program: ChainProgram, size_bytes: int, num_frames: int = 1
) -> int:
    """Wire bytes of the frame-pipelined execution of a ``pipeline``
    program: the store-and-forward scan applies EVERY chain edge on
    each of its F + L - 2 slots at 1/F-payload frame granularity
    (idle edge slots still ship a frame-sized buffer — the modeled HLO
    attribution of the scanned executor). ``num_frames <= 1`` is the
    stepped execution, i.e. :func:`program_wire_bytes`."""
    if program.kind != "pipeline" or num_frames <= 1 or not program.steps:
        return program.wire_bytes(size_bytes)
    counts: dict[int, int] = {}
    for s in program.steps:
        for src, _ in s.edges:
            counts[src] = counts.get(src, 0) + 1
    permutes = 1 + sum(c - 1 for c in counts.values())
    slots = num_frames + len(program.steps) - 1
    return slots * permutes * _ceil_div(size_bytes, num_frames)


# ---------------------------------------------------------------------------
# Partition validation helpers
# ---------------------------------------------------------------------------


def validate_chains(
    head: int, chains: Sequence[Sequence[int]]
) -> tuple[tuple[int, ...], ...]:
    """Clean + validate K disjoint broadcast sub-chains (head excluded
    from every chain; empty chains dropped). An empty *result* is
    allowed here (a head-only broadcast); ``multi_chain_broadcast``
    rejects it at its own layer."""
    head = int(head)
    clean = [tuple(int(d) for d in c) for c in chains if len(c)]
    seen: set[int] = set()
    for c in clean:
        for d in c:
            if d == head:
                raise ValueError("head cannot appear inside a chain")
            if d in seen:
                raise ValueError(f"destination {d} appears in two chains")
            seen.add(d)
    return tuple(clean)


def validate_ring_partition(
    axis_size: int, orders: Sequence[Sequence[int]]
) -> list[tuple[int, ...]]:
    """Clean + validate K disjoint equal-size sub-rings covering the
    whole axis. Pure host-side helper shared by the SPMD ring
    collectives, the planners and the property tests."""
    clean = [tuple(int(o) for o in c) for c in orders if len(c)]
    if not clean:
        raise ValueError("empty ring set")
    S = len(clean[0])
    if any(len(c) != S for c in clean):
        raise ValueError("sub-rings must have equal sizes")
    flat = [d for c in clean for d in c]
    if sorted(flat) != list(range(axis_size)):
        raise ValueError("sub-rings must partition the whole axis")
    return clean


def _check_rings(
    num_devices: int, orders: Sequence[Sequence[int]]
) -> tuple[tuple[int, ...], ...]:
    """Planner-level ring validation: disjoint, equal sizes, members in
    range. (Unlike :func:`validate_ring_partition` the rings need not
    cover every device — the simulator models rings over node subsets
    of a larger NoC.)"""
    clean = [tuple(int(o) for o in c) for c in orders if len(c)]
    if not clean:
        raise ValueError("empty ring set")
    S = len(clean[0])
    if any(len(c) != S for c in clean):
        raise ValueError("sub-rings must have equal sizes")
    flat = [d for c in clean for d in c]
    if len(set(flat)) != len(flat):
        raise ValueError("sub-rings must be disjoint")
    if any(not 0 <= d < num_devices for d in flat):
        raise ValueError("ring member out of device range")
    return tuple(clean)


def _ring_maps(orders: tuple[tuple[int, ...], ...]):
    """(intra_edges, cross_edges, pos, ring_of) for K equal-size rings."""
    K, S = len(orders), len(orders[0])
    intra = tuple(
        (c[p], c[(p + 1) % S]) for c in orders for p in range(S)
    ) if S > 1 else ()
    cross = tuple(
        (orders[j][r], orders[(j + 1) % K][r])
        for j in range(K)
        for r in range(S)
    ) if K > 1 else ()
    pos: dict[int, int] = {}
    ring_of: dict[int, int] = {}
    for j, ring in enumerate(orders):
        for p, d in enumerate(ring):
            pos[d] = p
            ring_of[d] = j
    return intra, cross, pos, ring_of


def _rows(num_devices: int, width: int) -> list[list[int]]:
    return [[-1] * width for _ in range(num_devices)]


# ---------------------------------------------------------------------------
# Planners
# ---------------------------------------------------------------------------

# Every planner memoizes on its full argument tuple, but BOUNDED: a
# large-L sweep must not pin every planned program in memory forever.
# LRU keeps the working set (one training/serving loop re-plans the
# same few programs); see planner_cache_stats() for hit rates.
_PLANNER_CACHE_MAXSIZE = 128


@functools.lru_cache(maxsize=_PLANNER_CACHE_MAXSIZE)
def plan_broadcast(
    num_devices: int, head: int, chains: tuple[tuple[int, ...], ...]
) -> ChainProgram:
    """P2MP multicast from ``head`` down K disjoint sub-chains.

    ``kind="pipeline"``: step ``t`` holds every chain's depth-``t``
    edge, so the steps double as the per-frame hop slots of the
    streamed (frame-pipelined) execution.
    """
    head = int(head)
    chains = validate_chains(head, chains)
    L = int(num_devices)
    full = [(head,) + c for c in chains]
    at_head = AtDevices((head,), 0)
    steps = []
    max_len = max((len(f) for f in full), default=1)
    for t in range(max_len - 1):
        edges = tuple((f[t], f[t + 1]) for f in full if t + 1 < len(f))
        steps.append(Step(
            edges=edges, width=1, tag="chain",
            write=AtDevices(tuple(dst for _, dst in edges), 0),
        ))
    return ChainProgram(
        collective="broadcast", kind="pipeline", num_devices=L,
        addr_shards=1, out_slots=1,
        buf_init=at_head, out_init=at_head,
        steps=tuple(steps), groups=chains, head=head,
    ).validate()


def plan_recovery(
    topo,
    src: int,
    chains: Sequence[Sequence[int]],
    failed: "int | Iterable[int]",
    *,
    scheduler: str = "tsp",
) -> ChainProgram:
    """Failure recovery of a multi-chain broadcast as a ChainProgram.

    ``chains`` is the (failure-free) partition the broadcast ran with;
    ``failed`` is one dead member or a set of concurrently dead members
    (each must belong to some chain; the initiator ``src`` cannot be
    recovered — raise before calling for that case). Per affected
    sub-chain the orphaned suffix is re-formed by
    ``scheduling.reform_chain`` (upstream prefix kept verbatim — the
    payload is banked there by store-and-forward) and emitted as
    ordered chain steps; the suffix streams from the last surviving
    prefix member (``group_heads``), or from ``src`` when the failure
    hit the chain head. Step 0 is the shared detection window
    (``tag="detect"``, no edges — the initiator's finish timeout fires
    once for every concurrent failure).

    Sub-chains with no failed member do not appear: recovery never
    perturbs them (the isolation invariant). A chain whose survivors
    all sit upstream of its failures contributes no steps either —
    nothing downstream is orphaned, only the detection window is paid
    (priced by ``simulator.chain_recovery_latency``).

    The returned program is consumed by ``simulator.program_latency`` /
    ``program_wire_bytes`` (recovery priced through the same machinery
    as every other schedule) and replays under
    ``chainwrite_ref.interpret_program`` — seed the banked heads with
    the payload and every re-sent survivor receives it.
    """
    chains_t = tuple(
        tuple(int(d) for d in c) for c in chains if len(c)
    )
    from .scheduling import normalize_failed  # host-side only

    return _plan_recovery_cached(
        topo, int(src), chains_t, tuple(normalize_failed(failed)), scheduler
    )


@functools.lru_cache(maxsize=_PLANNER_CACHE_MAXSIZE)
def _plan_recovery_cached(
    topo,
    src: int,
    chains: tuple[tuple[int, ...], ...],
    failed: tuple[int, ...],
    scheduler: str,
) -> ChainProgram:
    from .scheduling import reform_chain  # host-side only

    dead = set(failed)
    members = {d for c in chains for d in c}
    missing = dead - members
    if missing:
        raise ValueError(f"failed node(s) {sorted(missing)} are in no chain")
    L = int(topo.num_nodes)

    groups: list[tuple[int, ...]] = []
    heads: list[int] = []
    for chain in chains:
        chain_dead = [f for f in chain if f in dead]
        if not chain_dead:
            continue
        first = min(chain.index(f) for f in chain_dead)
        reformed = reform_chain(topo, chain, chain_dead, src, scheduler=scheduler)
        prefix, resent = reformed[:first], reformed[first:]
        if not resent:
            continue  # tail failure: nothing downstream to re-send
        groups.append(tuple(resent))
        heads.append(prefix[-1] if prefix else src)

    at_heads = AtDevices(tuple(dict.fromkeys(heads)), 0)
    steps: list[Step] = [Step(edges=(), tag="detect")]
    full = [(h,) + g for h, g in zip(heads, groups)]
    max_len = max((len(f) for f in full), default=1)
    for t in range(max_len - 1):
        edges = tuple((f[t], f[t + 1]) for f in full if t + 1 < len(f))
        # At t == 0 the banked members re-read the payload from local
        # memory (the detection window cleared the transit registers).
        steps.append(Step(
            edges=edges, width=1, tag="chain",
            load=at_heads if t == 0 else None,
            write=AtDevices(tuple(dst for _, dst in edges), 0),
        ))
    return ChainProgram(
        collective="recovery", kind="pipeline", num_devices=L,
        addr_shards=1, out_slots=1,
        buf_init=at_heads, out_init=at_heads,
        steps=tuple(steps), groups=tuple(groups), head=src,
        group_heads=tuple(heads),
    ).validate()


@functools.lru_cache(maxsize=_PLANNER_CACHE_MAXSIZE)
def plan_all_gather(
    num_devices: int, orders: tuple[tuple[int, ...], ...]
) -> ChainProgram:
    """Per-ring all-gather; K > 1 adds a cross-ring exchange of the
    gathered ring *blocks* (width-S steps). Output slots are device-id
    addressed — standard all_gather semantics for any ring order."""
    L = int(num_devices)
    orders = _check_rings(L, orders)
    K, S = len(orders), len(orders[0])
    intra, cross, _pos, _ring_of = _ring_maps(orders)

    steps: list[Step] = []
    for s in range(1, S):
        # write[d][0] = orders[ring][(pos - s) % S]
        steps.append(Step(
            edges=intra, width=1, tag="intra",
            write=MemberLookup(1, ar=1, ap=1, bp=-s),
        ))
    for c in range(1, K):
        # load (c==1): this ring's members; write: ring (ring - c)'s.
        steps.append(Step(
            edges=cross, width=S, tag="cross",
            load=MemberLookup(S, ar=1, ep=1) if c == 1 else None,
            write=MemberLookup(S, ar=1, br=-c, ep=1),
        ))
    return ChainProgram(
        collective="all_gather", kind="stepped", num_devices=L,
        addr_shards=1, out_slots=L,
        buf_init=Affine(1),  # members hold shard 0; non-members none
        out_init=Diag(L, Affine(1)),  # own slot seeded from own shard
        steps=tuple(steps), groups=orders,
    ).validate()


@functools.lru_cache(maxsize=_PLANNER_CACHE_MAXSIZE)
def plan_reduce_scatter(
    num_devices: int, orders: tuple[tuple[int, ...], ...]
) -> ChainProgram:
    """Reduce-scatter over K sub-rings: the input is ``num_devices``
    device-id-addressed chunks; device ``d`` ends with the fully
    reduced chunk ``d`` in out slot 0.

    K=1 is the classic ring schedule (1/L frames, L-1 steps). K > 1
    first reduce-scatters width-K chunk *groups* within each ring
    (group ``p`` = the chunks of every ring's position-``p`` member),
    then reduce-scatters each group across the rings at single-chunk
    width — same total wire as the single ring, shorter rounds.
    """
    L = int(num_devices)
    orders = _check_rings(L, orders)
    K, S = len(orders), len(orders[0])
    intra, cross, _pos, _ring_of = _ring_maps(orders)
    steps: list[Step] = []

    if K == 1:
        ring = orders[0]
        for s in range(1, S):
            # add[d][0] = ring[(pos - s - 1) % S]
            steps.append(Step(
                edges=intra, width=1, tag="intra", combine=ADD,
                add_src=MemberLookup(1, ar=1, ap=1, bp=-s - 1),
                write=Affine(1) if s == S - 1 else None,
            ))
        return ChainProgram(
            collective="reduce_scatter", kind="stepped", num_devices=L,
            addr_shards=L, out_slots=1,
            buf_init=MemberLookup(1, ar=1, ap=1, bp=-1),
            out_init=(
                AtDevices((ring[0],), ring[0]) if S == 1
                else AtDevices((), width=1)
            ),
            steps=tuple(steps), groups=orders,
        ).validate()

    out_slots = K
    if S == 1:
        # No intra phase: seed the group slots straight from the input.
        buf_init = AtDevices((), width=K)
        out_init = MemberLookup(K, er=1)  # out_init[d][j] = orders[j][0]
    else:
        # buf_init[d][j] = orders[j][(pos - 1) % S]
        buf_init = MemberLookup(K, er=1, ap=1, bp=-1)
        out_init = AtDevices((), width=K)
        for s in range(1, S):
            steps.append(Step(
                edges=intra, width=K, tag="intra", combine=ADD,
                add_src=MemberLookup(K, er=1, ap=1, bp=-s - 1),
                write=Affine(K, e=1, m=K) if s == S - 1 else None,
            ))
    for c in range(1, K):
        steps.append(Step(
            edges=cross, width=1, tag="cross", combine=ADD,
            add_from="out",
            add_src=Affine(1, c=1, b=-c - 1, m=K),
            load=Affine(1, c=1, b=-1, m=K) if c == 1 else None,
            write=Affine(1) if c == K - 1 else None,
        ))
    return ChainProgram(
        collective="reduce_scatter", kind="stepped", num_devices=L,
        addr_shards=L, out_slots=out_slots,
        buf_init=buf_init, out_init=out_init,
        steps=tuple(steps), groups=orders,
    ).validate()


def plan_all_reduce(
    num_devices: int,
    orders: tuple[tuple[int, ...], ...],
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
) -> ChainProgram:
    """All-reduce over K sub-rings (see module docstring for the two
    schedules). K=1 is the single-ring reduce-scatter + all-gather
    with *device-id* chunk addressing for either ``algo`` — the
    historical ``chain_all_reduce`` schedule, kept so its fold order
    (and therefore every bit-exactness pin) is unchanged.
    ``wire_dtype="int8"`` ships every hop quantized (per-hop int8 frame
    + f32 scale); it composes with any (K, algo). The wire variants
    share ONE cached plan (:meth:`ChainProgram.with_wire_dtype`)."""
    return _plan_all_reduce(num_devices, orders, algo).with_wire_dtype(
        wire_dtype
    )


@functools.lru_cache(maxsize=_PLANNER_CACHE_MAXSIZE)
def _plan_all_reduce(
    num_devices: int,
    orders: tuple[tuple[int, ...], ...],
    algo: str,
) -> ChainProgram:
    if algo not in ALL_REDUCE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}; expected {ALL_REDUCE_ALGOS}")
    L = int(num_devices)
    orders = _check_rings(L, orders)
    K, S = len(orders), len(orders[0])
    intra, cross, _pos, _ring_of = _ring_maps(orders)
    steps: list[Step] = []

    if K == 1 and S == L:
        # The full-axis single ring keeps the historical device-id
        # addressing (chunk i = device i's chunk). A *subset* ring —
        # simulator-only, the SPMD layer requires a full partition —
        # falls through to the position-addressed schedules below, so
        # its shard size is payload/S, not payload/num_devices.
        own = MemberLookup(1, ar=1, ap=1)  # slot = device id
        for s in range(1, S):  # reduce-scatter (device-id chunks)
            steps.append(Step(
                edges=intra, width=1, tag="intra", combine=ADD,
                add_src=MemberLookup(1, ar=1, ap=1, bp=-s - 1),
                write=own if s == S - 1 else None,
            ))
        for s in range(1, S):  # all-gather
            steps.append(Step(
                edges=intra, width=1, tag="intra",
                write=MemberLookup(1, ar=1, ap=1, bp=-s),
            ))
        return ChainProgram(
            collective="all_reduce", kind="stepped", num_devices=L,
            addr_shards=L, out_slots=L,
            buf_init=MemberLookup(1, ar=1, ap=1, bp=-1),
            out_init=Diag(L, own) if S == 1 else AtDevices((), width=L),
            steps=tuple(steps), groups=orders, algo=algo,
        ).validate()

    if algo == "rotation" or S == 1:
        # Full-payload rotations (S=1 rs_ag degenerates to the same
        # cross-only schedule: there is nothing to shard over).
        acc = Affine(1)  # members address frame/slot 0
        for _s in range(1, S):
            steps.append(Step(
                edges=intra, width=1, tag="intra",
                write=acc, write_op=ADD,
            ))
        for c in range(1, K):
            steps.append(Step(
                edges=cross, width=1, tag="cross",
                load=acc if c == 1 else None, write=acc, write_op=ADD,
            ))
        return ChainProgram(
            collective="all_reduce", kind="stepped", num_devices=L,
            addr_shards=1, out_slots=1,
            buf_init=acc, out_init=acc,
            steps=tuple(steps), groups=orders, algo=algo,
        ).validate()

    # rs_ag, K > 1, S > 1: shards addressed by ring position.
    pos_write = Affine(1, a=1, m=S)  # slot = own ring position
    for s in range(1, S):  # fused per-ring reduce-scatter
        steps.append(Step(
            edges=intra, width=1, tag="intra", combine=ADD,
            add_src=Affine(1, a=1, b=-s - 1, m=S),
            write=pos_write if s == S - 1 else None,
        ))
    for _c in range(1, K):  # cross-ring shard rotation (accumulating)
        steps.append(Step(
            edges=cross, width=1, tag="cross",
            write=pos_write, write_op=ADD,
        ))
    for s in range(1, S):  # fused per-ring all-gather
        steps.append(Step(
            edges=intra, width=1, tag="intra",
            load=pos_write if s == 1 else None,
            write=Affine(1, a=1, b=-s, m=S),
        ))
    return ChainProgram(
        collective="all_reduce", kind="stepped", num_devices=L,
        addr_shards=S, out_slots=S,
        buf_init=Affine(1, a=1, b=-1, m=S),
        out_init=AtDevices((), width=S),
        steps=tuple(steps), groups=orders, algo=algo,
    ).validate()


def plan_all_to_all(
    num_devices: int,
    orders: tuple[tuple[int, ...], ...],
    wire_dtype: str | None = None,
) -> ChainProgram:
    """All-to-all (MoE dispatch): chunk ``j`` of each device's train is
    destined to device ``j``. The train rotates whole; each device
    peels the chunk addressed to it every step. K > 1 interleaves
    intra-ring rotations with cross-ring hops — (K·(S-1) + (K-1)) =
    L-1 steps either way (a chunk train cannot shrink), but every hop
    stays ring-local/position-paired. ``wire_dtype="int8"`` ships the
    rotating train quantized (per-hop int8 frame + f32 scale). The
    wire variants share ONE cached plan
    (:meth:`ChainProgram.with_wire_dtype`)."""
    return _plan_all_to_all(num_devices, orders).with_wire_dtype(wire_dtype)


@functools.lru_cache(maxsize=_PLANNER_CACHE_MAXSIZE)
def _plan_all_to_all(
    num_devices: int,
    orders: tuple[tuple[int, ...], ...],
) -> ChainProgram:
    L = int(num_devices)
    orders = _check_rings(L, orders)
    K, S = len(orders), len(orders[0])
    intra, cross, _pos, _ring_of = _ring_maps(orders)

    def peel(j: int, t: int) -> Diag:
        # write[d][d] = orders[(ring - j) % K][(pos - t) % S]: the train
        # at (ring, pos) originated j cross hops / t intra hops back.
        return Diag(L, MemberLookup(1, ar=1, br=-j, ap=1, bp=-t))

    steps: list[Step] = []
    for j in range(K):
        # After j cross hops and t intra hops the train at device (c, p)
        # originated at ring (c - j), position (p - t) — the intra
        # offset accumulates across stages.
        if j > 0:
            steps.append(Step(
                edges=cross, width=L, tag="cross",
                write=peel(j, j * (S - 1)),
            ))
        for s in range(1, S):
            steps.append(Step(
                edges=intra, width=L, tag="intra",
                write=peel(j, j * (S - 1) + s),
            ))
    return ChainProgram(
        collective="all_to_all", kind="stepped", num_devices=L,
        addr_shards=L, out_slots=L,
        buf_init=Affine(L, e=1, m=L),  # chunk train: iota row
        out_init=Diag(L, MemberLookup(1, ar=1, ap=1)),  # own chunk
        steps=tuple(steps), groups=orders,
    ).validate()


# ---------------------------------------------------------------------------
# Planner cache instrumentation
# ---------------------------------------------------------------------------

# The memoized planner entry points (public name -> cached callable).
# Keys must stay COMPLETE: every argument that changes the emitted
# program is part of the cache key (regression-tested).
PLANNER_CACHES = {
    "plan_broadcast": plan_broadcast,
    "plan_recovery": _plan_recovery_cached,
    "plan_all_gather": plan_all_gather,
    "plan_reduce_scatter": plan_reduce_scatter,
    "plan_all_reduce": _plan_all_reduce,
    "plan_all_to_all": _plan_all_to_all,
}


def planner_cache_stats() -> dict[str, dict[str, int]]:
    """Per-planner ``lru_cache`` statistics (hits/misses/maxsize/
    currsize) — the observability hook for cache sizing."""
    return {
        name: fn.cache_info()._asdict()
        for name, fn in PLANNER_CACHES.items()
    }


def clear_planner_caches() -> None:
    """Drop every memoized plan (benchmarks time cold planning)."""
    for fn in PLANNER_CACHES.values():
        fn.cache_clear()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
