"""Pure-numpy oracles for the Chainwrite collectives.

Two layers of oracle live here:

* **Semantic oracles** (``broadcast_ref``, ``all_gather_ref``,
  ``reduce_scatter_ref``, ``all_reduce_ref``, ``all_to_all_ref``, ...)
  state what each collective must *compute*, independent of any
  schedule — the ground truth the planners are checked against.

* **The program interpreter** (:func:`interpret_program` /
  :func:`run_program_ref`) replays any
  :class:`~repro.core.program.ChainProgram` step for step on the
  global ``(L, ...)`` view — the numpy twin of
  ``chainwrite.execute_program``. Because both backends interpret the
  SAME program (same permutes, same left-folded additions), the SPMD
  collectives are pinned BIT-exactly against it: float addition is not
  associative, so value equality up to reassociation would hide
  scheduling bugs. This one interpreter replaces the hand-written
  per-collective replays that previously lived here.

Each function takes the *global* view — ``xs[d]`` is device ``d``'s
input along the axis — and returns the global stacked outputs.
Used by tests/test_chainwrite_collectives.py and friends.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import program as prg

# Canonical multi-ring all-reduce schedule names (re-exported from the
# schedule IR so the SPMD layer, the simulator and the CLI keep
# validating against ONE tuple).
ALL_REDUCE_ALGOS = prg.ALL_REDUCE_ALGOS


def broadcast_ref(
    xs: np.ndarray, order: Sequence[int]
) -> np.ndarray:
    """xs: (L, ...) per-device inputs. Devices in ``order`` end with the
    head's payload; everyone else ends with zeros."""
    out = np.zeros_like(xs)
    head = order[0]
    for d in order:
        out[d] = xs[head]
    return out


def multi_broadcast_ref(
    xs: np.ndarray, head: int, chains: Sequence[Sequence[int]]
) -> np.ndarray:
    """Oracle for ``multi_chain_broadcast``: the head and every member
    of any sub-chain end with the head's payload; everyone else ends
    with zeros. Chain structure/frames affect latency, not values."""
    out = np.zeros_like(xs)
    out[head] = xs[head]
    for chain in chains:
        for d in chain:
            out[d] = xs[head]
    return out


def degraded_multi_broadcast_ref(
    xs: np.ndarray, head: int, chains: Sequence[Sequence[int]], failed
) -> np.ndarray:
    """Oracle for ``degraded_multi_chain_broadcast``: the head and every
    *surviving* chain member end with the head's payload; the failed
    node(s) — like any non-member — end with zeros. ``failed`` is one
    node id or a set of concurrently dead members."""
    dead = (
        {int(failed)}
        if isinstance(failed, (int, np.integer))
        else {int(f) for f in failed}
    )
    out = np.zeros_like(xs)
    out[head] = xs[head]
    for chain in chains:
        for d in chain:
            if d not in dead:
                out[d] = xs[head]
    return out


def all_gather_ref(xs: np.ndarray, tiled: bool = False) -> np.ndarray:
    """Every device ends with the full stack (device-id indexed) —
    independent of ring order."""
    L = xs.shape[0]
    full = xs if not tiled else xs.reshape((L * xs.shape[1],) + xs.shape[2:])
    return np.stack([full] * L)


def reduce_scatter_ref(xs: np.ndarray) -> np.ndarray:
    """xs: (L, L, chunk...) — xs[d][j] is device d's contribution to
    chunk j. Device d ends with sum_d' xs[d'][d]."""
    L = xs.shape[0]
    total = xs.sum(axis=0)  # (L, chunk...)
    return np.stack([total[d] for d in range(L)])


def all_reduce_ref(xs: np.ndarray) -> np.ndarray:
    """Every device ends with the elementwise sum."""
    total = xs.sum(axis=0)
    return np.stack([total] * xs.shape[0])


def all_to_all_ref(xs: np.ndarray) -> np.ndarray:
    """xs: (L, L, chunk...) — xs[s][d] is the chunk device s sends to
    device d. Device d ends with out[s] = xs[s][d] (transpose)."""
    return np.swapaxes(xs, 0, 1)


# ---------------------------------------------------------------------------
# The numpy program interpreter
# ---------------------------------------------------------------------------


def _is_float_dtype(dt) -> bool:
    """True for numpy floats AND the ml_dtypes extension floats
    (bfloat16, float8_*) that ``np.issubdtype`` does not classify."""
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return True
    try:
        import ml_dtypes

        ml_dtypes.finfo(dt)
        return True
    except (ImportError, ValueError):
        return False


def _quantize_ref(x: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """Numpy twin of ``repro.runtime.compression.quantize``: identical
    f32 arithmetic (f32 max, power-of-two divisor, round-half-to-even,
    17-bit scale mantissa), so the wire replay is bit-exact against the
    SPMD executor: the /128 divisor makes XLA's divide-by-constant →
    multiply-by-reciprocal rewrite exact, and the truncated scale makes
    every dequantize product exact in f32, which neutralises FMA
    contraction of dequantize-mul + accumulate-add."""
    x = np.asarray(x, np.float32)
    scale = np.float32(
        np.max(np.abs(x)) / np.float32(128.0) + np.float32(1e-12)
    )
    scale = np.float32(
        (np.asarray(scale, np.float32).view(np.uint32) & np.uint32(0xFFFFFF80))
        .view(np.float32)
    )
    q = np.clip(np.round(x / scale), -127.0, 127.0).astype(np.int8)
    return q, scale


def _dequantize_ref(q: np.ndarray, scale: np.float32) -> np.ndarray:
    return q.astype(np.float32) * scale


def interpret_program(shards: np.ndarray, prog: prg.ChainProgram) -> np.ndarray:
    """Replay ``prog`` on the global pre-blocked view ``shards``
    (``(L, addr_shards, m, ...)``); returns the global out slots
    ``(L, out_slots, m, ...)``. Implements the machine model documented
    in :mod:`repro.core.program` verbatim — the numpy twin of
    ``chainwrite.execute_program``."""
    L = prog.num_devices
    if shards.shape[0] != L or shards.shape[1] != prog.addr_shards:
        raise ValueError(
            f"shards {shards.shape} incompatible with program "
            f"(L={L}, addr_shards={prog.addr_shards})"
        )
    inner = shards.shape[2:]
    wires = [prog.step_wire_dtype(s) for s in prog.steps]
    orig_dtype = shards.dtype
    if any(w is not None for w in wires):
        # Mirror the executor: the compressed wire computes in f32.
        if not _is_float_dtype(shards.dtype):
            raise ValueError(
                f"wire_dtype='int8' requires a floating payload, "
                f"got {shards.dtype}"
            )
        shards = shards.astype(np.float32)

    def rows(table, source, keep=None):
        # Symbolic tables materialize lazily — the replay (and thus
        # every bit-exactness pin) is identical to the dense form.
        table = prg.resolve_table(prog, table)
        width = len(table[0])
        out = np.zeros((L, width) + inner, shards.dtype)
        for d in range(L):
            for j in range(width):
                v = table[d][j]
                if v >= 0:
                    out[d, j] = source[d, v]
                elif keep is not None and keep.shape[1] == width:
                    out[d, j] = keep[d, j]
        return out

    buf = rows(prog.buf_init, shards)
    out = rows(prog.out_init, shards)
    for step, wire in zip(prog.steps, wires):
        if step.load is not None:
            buf = rows(step.load, out, keep=buf)
        new = np.zeros((L, step.width) + inner, shards.dtype)
        if wire == "int8":
            # Per-hop quantized wire: every device quantizes its whole
            # buf with one f32 scale; the destination dequantizes.
            # Non-targets keep zeros — dequantize(0, 0) = 0 in SPMD.
            qs = [_quantize_ref(buf[d]) for d in range(L)]
            for src, dst in step.edges:
                new[dst] = _dequantize_ref(*qs[src])
        else:
            for src, dst in step.edges:
                new[dst] = buf[src]
        buf = new
        if step.combine == prg.ADD:
            source = shards if step.add_from == "input" else out
            buf = buf + rows(step.add_src, source)
        if step.write is not None:
            write_tbl = prg.resolve_table(prog, step.write)
            for d in range(L):
                for j in range(step.width):
                    slot = write_tbl[d][j]
                    if slot >= 0:
                        if step.write_op == prg.COPY:
                            out[d, slot] = buf[d, j]
                        else:
                            out[d, slot] = out[d, slot] + buf[d, j]
    return out.astype(orig_dtype)


def run_program_ref(
    xs: np.ndarray, prog: prg.ChainProgram, *, tiled: bool = False
) -> np.ndarray:
    """:func:`interpret_program` plus the same per-collective input
    blocking / output assembly as ``chainwrite.execute_program`` —
    global in, global out."""
    L = prog.num_devices
    if xs.shape[0] != L:
        raise ValueError(f"global view has {xs.shape[0]} rows, expected {L}")
    c = prog.collective
    if c in ("broadcast", "all_gather"):
        out = interpret_program(xs[:, None], prog)
        if c == "broadcast":
            return out[:, 0]
        if tiled:
            return out.reshape((L, L * xs.shape[1]) + xs.shape[2:])
        return out
    if c in ("reduce_scatter", "all_to_all"):
        if xs.shape[1] != L:
            raise ValueError(f"leading dim {xs.shape[1]} != axis size {L}")
        out = interpret_program(xs, prog)
        return out[:, 0] if c == "reduce_scatter" else out
    if c == "all_reduce":
        S = prog.addr_shards
        lead = xs.shape[1]
        pad = (-lead) % S
        xp = (
            np.pad(xs, [(0, 0), (0, pad)] + [(0, 0)] * (xs.ndim - 2))
            if pad
            else xs
        )
        shards = xp.reshape((L, S, xp.shape[1] // S) + xs.shape[2:])
        out = interpret_program(shards, prog)
        if prog.out_slots == 1:  # rotation: whole payload in one slot
            full = out[:, 0]
        else:
            full = out.reshape((L, out.shape[1] * out.shape[2]) + xs.shape[2:])
        return full[:, :lead] if pad else full
    raise ValueError(f"unknown collective {c!r}")


def multi_all_reduce_ref(
    xs: np.ndarray, orders, algo: str = "rs_ag",
    wire_dtype: str | None = None,
) -> np.ndarray:
    """Oracle for ``multi_chain_all_reduce``: plans the same
    :class:`ChainProgram` the SPMD collective executes and replays it
    with :func:`run_program_ref`, so the result matches bit-exactly —
    including every per-hop quantization when ``wire_dtype="int8"``.
    ``xs`` is the (L, n, ...) global view. K=1 is — like the SPMD
    implementation — the single-ring reduce-scatter + all-gather with
    device-id chunk addressing, for either ``algo``.
    """
    orders = tuple(tuple(int(d) for d in c) for c in orders if len(c))
    if not orders:
        raise ValueError("empty ring set")
    if algo not in ALL_REDUCE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}; expected {ALL_REDUCE_ALGOS}")
    prog = prg.plan_all_reduce(xs.shape[0], orders, algo, wire_dtype=wire_dtype)
    return run_program_ref(xs, prog)


def multi_reduce_scatter_ref(xs: np.ndarray, orders) -> np.ndarray:
    """Schedule-replaying oracle for ``multi_chain_reduce_scatter``."""
    orders = tuple(tuple(int(d) for d in c) for c in orders if len(c))
    prog = prg.plan_reduce_scatter(xs.shape[0], orders)
    return run_program_ref(xs, prog)


def multi_all_gather_ref(
    xs: np.ndarray, orders, tiled: bool = False
) -> np.ndarray:
    """Schedule-replaying oracle for ``multi_chain_all_gather``."""
    orders = tuple(tuple(int(d) for d in c) for c in orders if len(c))
    prog = prg.plan_all_gather(xs.shape[0], orders)
    return run_program_ref(xs, prog, tiled=tiled)


def multi_all_to_all_ref(
    xs: np.ndarray, orders, wire_dtype: str | None = None
) -> np.ndarray:
    """Schedule-replaying oracle for ``multi_chain_all_to_all``."""
    orders = tuple(tuple(int(d) for d in c) for c in orders if len(c))
    prog = prg.plan_all_to_all(xs.shape[0], orders, wire_dtype=wire_dtype)
    return run_program_ref(xs, prog)
