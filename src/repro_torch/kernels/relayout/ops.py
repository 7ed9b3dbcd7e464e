"""Public entry points for the relayout kernel (``csrc/relayout.cu``).

``relayout`` runs the plain twin :func:`.ref.relayout_ref` for a CPU
tensor and launches a CUDA kernel for a CUDA tensor; there is no other
path. Which of the kernel's three routes runs is a plain function of the
shapes, the element size and the pointer alignment (:func:`_route`):

* ``"copy"`` — the two blockings give the same byte order (the paged-KV
  case ``(1, F) -> (page, F)``, equal blockings): a streaming copy;
* ``"staged"`` — both pointers 16-byte aligned and the lcm super-tile
  fits one stage of shared memory (``STAGE_MAX_BYTES``): super-tiles
  staged in shared memory, 16-byte loads and stores on both sides;
* ``"direct"`` — everything else: one thread per output unit, the
  address map computed in 32-bit arithmetic.

Every launch indexes in 32 bits: a transform whose byte extent exceeds
``LAUNCH_BYTES`` is split into bands contiguous in both layouts
(:func:`_bands`). Divisions inside the kernels are multiplications by
magic numbers computed here (:func:`_magic`). The launch plan of a
(shape, blocks, element size, pointer alignment, SM count) is built once
and cached (:func:`_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .ref import blocked_to_dense, dense_to_blocked, parse_layout, relayout_ref

__all__ = [
    "relayout",
    "relayout_str",
    "relayout_ref",
    "parse_layout",
    "dense_to_blocked",
    "blocked_to_dense",
]

ROUTES = ("copy", "staged", "direct")  # index = the route word of a plan
THREADS = 256  # per block, every route (kThreads in relayout.cu)
LAUNCH_BYTES = 1 << 31  # most bytes one launch spans: every offset < 2^31
# staged route: a super-tile aims at STAGE_BYTES and may not exceed
# STAGE_MAX_BYTES; a block holds two stages (a 2-stage ring), and as many
# blocks share an SM as SM_SMEM_BYTES allows (at most 8).
STAGE_BYTES = 16 << 10
STAGE_MAX_BYTES = 48 << 10
SM_SMEM_BYTES = 227 << 10
COPY_LOADS = 4  # 16-byte loads in flight per thread on the copy route
BLOCKS_PER_SM = 8  # most resident blocks per SM any route's grid asks for


def _unit_bytes(elsize: int, sbn: int, dbn: int, *ptrs: int) -> int:
    """Widest load/store unit (<= 16 B) that divides both block rows in
    bytes and the alignment of every pointer (the direct route's unit)."""
    for unit in (16, 8, 4, 2, 1):
        if (
            unit % elsize == 0
            and (sbn * elsize) % unit == 0
            and (dbn * elsize) % unit == 0
            and all(p % unit == 0 for p in ptrs)
        ):
            return unit
    return elsize


def _magic(d: int) -> tuple[int, int, int]:
    """``(mul, shift, d)`` such that ``n // d == (umulhi(n, mul) + n) >> shift``
    for every ``0 <= n < 2**31`` (``Div`` in relayout.cu): ``shift`` is
    ceil(log2 d) and ``mul = floor(2^32 (2^shift - d) / d) + 1`` < 2^32.
    The 32-bit sum cannot overflow, since ``umulhi(n, mul) <= n < 2^31``."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift, d


def _magic_divmod(n: int, magic: tuple[int, int, int]) -> tuple[int, int]:
    """What ``Div::divmod`` computes on the card, in 32-bit arithmetic."""
    mul, shift, d = magic
    q = ((((n * mul) >> 32) + n) & 0xFFFFFFFF) >> shift
    return q, n - q * d


def _is_identity(shape, src_block, dst_block) -> bool:
    """Whether both blockings put every element at the same offset: a
    blocking of one-row blocks, or of full-width blocks, is row-major."""
    M, N = shape

    def canon(block):
        return (1, N) if block[0] == 1 or block[1] == N else tuple(block)

    return canon(src_block) == canon(dst_block)


def _tile_perm(tile, src_block, dst_block) -> np.ndarray:
    """For each element of a super-tile in destination-blocked order, its
    element offset in the source-blocked tile."""
    TM, TN = tile
    (sbm, sbn), (dbm, dbn) = src_block, dst_block
    src = np.arange(TM * TN, dtype=np.int64).reshape(TM // sbm, TN // sbn, sbm, sbn)
    dense = src.transpose(0, 2, 1, 3).reshape(TM, TN)
    return dense.reshape(TM // dbm, dbm, TN // dbn, dbn).transpose(0, 2, 1, 3).reshape(-1)


def _piece_bytes(perm: np.ndarray, elsize: int) -> int:
    """Widest piece (<= 16 B) that every aligned destination piece reads
    as one aligned run of the source tile."""
    for piece in (16, 8, 4, 2):
        pe = piece // elsize
        if pe < 1 or perm.size % pe:
            continue
        starts = perm[::pe]
        if (starts % pe == 0).all() and (
            perm.reshape(-1, pe) == starts[:, None] + np.arange(pe)
        ).all():
            return piece
    return elsize


def _swizzle(b: np.ndarray, m: int) -> np.ndarray:
    """``swizzle`` of relayout.cu: XOR a 16-byte chunk's position in its
    128-byte line with ``line * m`` (mod 8)."""
    c = b >> 4
    line = c >> 3
    return (((line << 3) | ((c ^ (line * m)) & 7)) << 4) | (b & 15)


def _bank_conflicts(perm: np.ndarray, elsize: int, piece: int, m: int) -> int:
    """Worst shared-memory bank conflict of the staged route's gather: the
    most distinct 4-byte words one bank serves in one phase of a warp's
    piece load (a phase is 128 bytes of requests), over the whole tile."""
    P = 16 // piece
    units = perm.size * elsize // 16
    warps = units // 32
    if warps == 0:
        return 1
    starts = perm[:: piece // elsize][: warps * 32 * P] * elsize
    addr = _swizzle(starts, m).reshape(warps, 32, P).transpose(0, 2, 1)  # (warp, q, lane)
    per_phase = max(1, 128 // piece)
    wpt = max(1, piece // 4)  # words a thread touches
    words = (addr[..., None] // 4 + np.arange(wpt)).reshape(-1, per_phase * wpt)
    words = np.sort(words, axis=1)
    new = np.ones_like(words, dtype=bool)
    new[:, 1:] = words[:, 1:] != words[:, :-1]
    counts = np.zeros((words.shape[0], 32), dtype=np.int64)
    rows = np.broadcast_to(np.arange(words.shape[0])[:, None], words.shape)
    np.add.at(counts, (rows[new], (words % 32)[new]), 1)
    return int(counts.max())


def _staged_tile(shape, src_block, dst_block, elsize: int, sms: int):
    """The staged route's super-tile ``(TM, TN)``: lcm(sbm, dbm) x
    lcm(sbn, dbn) scaled up by divisors of the grid of such tiles, wider
    first, toward ``STAGE_BYTES`` (less when the whole transform would
    give fewer than two tiles per SM). Every source and destination run
    of a tile must be a multiple of 16 bytes. None if no such tile fits
    ``STAGE_MAX_BYTES``."""
    M, N = shape
    (sbm, sbn), (dbm, dbn) = src_block, dst_block
    lm, ln = math.lcm(sbm, dbm), math.lcm(sbn, dbn)
    base = lm * ln * elsize
    if base > STAGE_MAX_BYTES:
        return None
    target = max(base, min(STAGE_BYTES, M * N * elsize // (2 * sms)))
    widths = [ln * k for k in range(1, STAGE_MAX_BYTES // base + 1) if (N // ln) % k == 0]
    aligned = [tn for tn in widths if (tn * sbm * elsize) % 16 == 0 and (tn * dbm * elsize) % 16 == 0]
    if not aligned:
        return None
    fit = [tn for tn in aligned if lm * tn * elsize <= target]
    TN = fit[-1] if fit else aligned[0]
    heights = [lm * q for q in range(1, STAGE_MAX_BYTES // (lm * TN * elsize) + 1)
               if (M // lm) % q == 0 and lm * q * N * elsize <= LAUNCH_BYTES]
    fit = [tm for tm in heights if tm * TN * elsize <= target]
    return (fit[-1] if fit else lm), TN


def _route(shape, src_block, dst_block, elsize: int, src_ptr: int, dst_ptr: int,
           sms: int = 132) -> str:
    """The kernel route a CUDA call with these arguments takes."""
    aligned = src_ptr % 16 == 0 and dst_ptr % 16 == 0
    if aligned and _is_identity(shape, src_block, dst_block):
        return "copy"
    if aligned and _staged_tile(shape, src_block, dst_block, elsize, sms) is not None:
        return "staged"
    return "direct"


def _bands(total_rows: int, row_bytes: int, step: int) -> list[tuple[int, int]]:
    """``(first row, rows)`` of each launch: bands of a multiple of
    ``step`` rows (a multiple of lcm(sbm, dbm), so each band is
    contiguous in both layouts) of at most ``LAUNCH_BYTES``."""
    if step * row_bytes > LAUNCH_BYTES:
        raise ValueError(
            f"relayout: {step} rows of {row_bytes} bytes exceed the 2^31-byte "
            "extent of one launch"
        )
    per = LAUNCH_BYTES // (step * row_bytes) * step
    return [(r, min(per, total_rows - r)) for r in range(0, total_rows, per)]


class Plan(NamedTuple):
    route: str
    bands: tuple  # ((byte offset of the band in both tensors, plan words), ...)
    info: dict  # tile, piece, swizzle, bank conflicts, unit (for reports and tests)


@functools.lru_cache(maxsize=512)
def _plan(shape, src_block, dst_block, elsize: int, src_align: int, dst_align: int,
          sms: int) -> Plan:
    """Every launch of one call, as the 32-bit words each route's struct
    in relayout.cu reads (route, grid, ...), one list per band."""
    M, N = shape
    (sbm, sbn), (dbm, dbn) = src_block, dst_block
    route = _route(shape, src_block, dst_block, elsize, src_align, dst_align, sms)
    row_bytes = N * elsize
    if route == "copy":  # any byte split keeps the identity
        total = M * row_bytes
        bands = []
        for off in range(0, total, LAUNCH_BYTES):
            nbytes = min(LAUNCH_BYTES, total - off)
            units = nbytes // 16
            grid = max(1, min(-(-units // (COPY_LOADS * THREADS)), BLOCKS_PER_SM * sms))
            bands.append((off, (0, grid, units, nbytes % 16)))
        return Plan(route, tuple(bands), {})
    lm = math.lcm(sbm, dbm)
    if route == "staged":
        TM, TN = _staged_tile(shape, src_block, dst_block, elsize, sms)
        perm = _tile_perm((TM, TN), src_block, dst_block)
        piece = _piece_bytes(perm, elsize)
        conflicts = {m: _bank_conflicts(perm, elsize, piece, m) for m in range(8)}
        swz = min(conflicts, key=lambda m: (conflicts[m], m))
        tile_bytes = TM * TN * elsize
        # Each stage starts on a 128-byte line: the swizzle permutes the
        # chunks of a whole line, so a tile whose last line is partial
        # spreads that line over all of it (and the bank analysis above
        # assumes line-aligned stages).
        stage = -(-tile_bytes // 128) * 128
        assert int(_swizzle(np.arange(0, tile_bytes, 16), swz).max()) < stage
        smem = 2 * stage
        per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + 1024)))
        src_seg, dst_seg = TN * sbm * elsize, TN * dbm * elsize
        bands = []
        for r0, rows in _bands(M, row_bytes, TM):
            n_tiles = rows // TM * (N // TN)
            words = (
                1, min(n_tiles, per_sm * sms), piece, smem, n_tiles, *_magic(N // TN),
                TM * row_bytes, src_seg, dst_seg, sbm * row_bytes, dbm * row_bytes,
                tile_bytes, *_magic(src_seg // 16), *_magic(dst_seg // 16),
                piece // elsize, elsize.bit_length() - 1,
                *_magic(dbn), *_magic(dbm), *_magic(TN // dbn), *_magic(sbm), *_magic(sbn),
                TN // sbn, swz,
            )
            bands.append((r0 * row_bytes, words))
        info = {"tile": (TM, TN), "piece": piece, "swizzle": swz,
                "bank_conflicts": conflicts[swz], "blocks_per_sm": per_sm}
        return Plan(route, tuple(bands), info)
    unit = _unit_bytes(elsize, sbn, dbn, src_align, dst_align)
    per = unit // elsize
    Nu, su, du = N // per, sbn // per, dbn // per
    bands = []
    for r0, rows in _bands(M, row_bytes, lm):
        total = rows * Nu
        grid = max(1, min(-(-total // THREADS), BLOCKS_PER_SM * sms))
        words = (
            2, grid, unit, total, *_magic(du), *_magic(dbm), *_magic(Nu // du),
            *_magic(sbm), *_magic(su), Nu // su,
        )
        bands.append((r0 * row_bytes, words))
    return Plan(route, tuple(bands), {"unit": unit})


_SMS: dict[int, int] = {}  # device index -> SM count


@functools.cache
def _launcher():
    """``relayout_launch`` and ``relayout_plan_words`` of the built
    library, with their ctypes signatures (loaded, and built, once)."""
    lib = _build.load("relayout")
    fn = lib.relayout_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.relayout_plan_words.argtypes = [ctypes.c_int]
    lib.relayout_plan_words.restype = ctypes.c_int
    return fn, lib.relayout_plan_words


@functools.lru_cache(maxsize=512)
def _band_args(bands) -> tuple:
    """Each band's (byte offset, plan words as a ctypes array), checked
    once against the size of the kernel's plan struct."""
    plan_words = _launcher()[1]
    args = []
    for off, words in bands:
        if len(words) != plan_words(words[0]) or not all(0 <= w < 1 << 32 for w in words):
            raise RuntimeError(f"relayout: malformed {ROUTES[words[0]]} plan {words}")
        args.append((off, (ctypes.c_uint32 * len(words))(*words)))
    return tuple(args)


def relayout(
    x: torch.Tensor,
    shape: tuple[int, int],
    src_block: tuple[int, int],
    dst_block: tuple[int, int],
) -> torch.Tensor:
    """Blocked(src_block) -> blocked(dst_block) layout transform.

    ``x``: (M//sbm, N//sbn, sbm, sbn). Returns (M//dbm, N//dbn, dbm, dbn)
    in ``x``'s dtype, bit-identical to :func:`relayout_ref`. Raises
    under autograd (grad mode on and ``x`` requiring grad): the kernel
    has no backward.
    """
    _build.refuse_autograd("relayout", x)
    M, N = shape
    sbm, sbn = src_block
    dbm, dbn = dst_block
    if (M % sbm, N % sbn, M % dbm, N % dbn) != (0, 0, 0, 0):
        raise ValueError(f"blocks {src_block}/{dst_block} must divide {shape}")
    if tuple(x.shape) != (M // sbm, N // sbn, sbm, sbn):
        raise ValueError(
            f"x has shape {tuple(x.shape)}, expected {(M // sbm, N // sbn, sbm, sbn)}"
        )
    device = x.device
    if device.type == "cpu":
        return relayout_ref(x, shape, src_block, dst_block)
    if device.type != "cuda":
        raise ValueError(f"relayout: unsupported device {device}")
    if not x.is_contiguous():
        raise ValueError("relayout: x must be contiguous")
    out = torch.empty((M // dbm, N // dbn, dbm, dbn), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    dev = device.index
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    src, dst = x.data_ptr(), out.data_ptr()
    plan = _plan((M, N), (sbm, sbn), (dbm, dbn), x.element_size(), src % 16, dst % 16, sms)
    if dev == torch.cuda.current_device():
        _launch(plan, src, dst, dev)
    else:
        with torch.cuda.device(dev):
            _launch(plan, src, dst, dev)
    return out


def _launch(plan: Plan, src: int, dst: int, dev: int) -> None:
    """Launch every band of ``plan`` on the current stream of device
    ``dev`` (the current device); counts each launch in
    ``relayout.launches`` and ``relayout.launches_by_route``."""
    fn, route = _launcher()[0], plan.route
    stream = _build.raw_stream(dev)
    for off, words in _band_args(plan.bands):
        err = fn(src + off, dst + off, words, stream)
        if err:
            raise RuntimeError(f"relayout {route} kernel launch failed: CUDA error {err}")
        relayout.launches += 1
        relayout.launches_by_route[route] += 1


relayout.launches = 0
relayout.launches_by_route = dict.fromkeys(ROUTES, 0)


def relayout_str(
    x: torch.Tensor,
    shape: tuple[int, int],
    src_layout: str,
    dst_layout: str,
) -> torch.Tensor:
    """Same, with the paper's layout strings (e.g. ``"MNM16N8"``)."""
    return relayout(x, shape, parse_layout(src_layout), parse_layout(dst_layout))
