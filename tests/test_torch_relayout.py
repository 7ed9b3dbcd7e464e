"""The port's relayout entry points against the JAX relayout kernel
(Pallas, interpret mode) and ``relayout_ref``.

On the CPU ``repro_torch.kernels.relayout.relayout`` runs its plain twin;
it must be bit-exact against both JAX paths for f32 and bf16 (compared as
``uint16``) and raise the same ``ValueError``s. The CUDA kernel itself is
held against the same twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

What the CUDA wrapper decides in Python is pinned here: the route each
call takes, the magic-number division the kernels use, the row bands
that keep every launch's offsets below 2^31, and the launch plans
themselves, run through a numpy model of what each route's kernel does
with its plan words and held bit for bit against ``relayout_ref``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.relayout import ops as JR  # noqa: E402
from repro_torch.kernels.relayout import ops as TR  # noqa: E402

BLOCKS = [(16, 8), (8, 8), (64, 16), (16, 16)]  # the paper's layouts
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dtype, seed=0):
    """The same values as a JAX array and a torch tensor (bit-identical)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x).astype(jd)
    t = torch.from_numpy(x).to(td)
    return j, t


def _bits(a) -> np.ndarray:
    """Raw bits of a JAX array or torch tensor, for bit-exact compares."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("src", BLOCKS)
@pytest.mark.parametrize("dst", BLOCKS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_relayout_sweep_matches_jax(src, dst, dtype):
    shape = (128, 64)
    if any(shape[0] % b[0] or shape[1] % b[1] for b in (src, dst)):
        with pytest.raises(ValueError):
            TR.relayout(torch.zeros(1, 1, 1, 1), shape, src, dst)
        return
    jd, td = _pair(shape, dtype)
    np.testing.assert_array_equal(_bits(td), _bits(jd))  # same inputs
    jx = JR.dense_to_blocked(jd, src)
    tx = TR.dense_to_blocked(td, src)
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    got = TR.relayout(tx, shape, src, dst)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (
        shape[0] // dst[0], shape[1] // dst[1], dst[0], dst[1]
    )
    np.testing.assert_array_equal(_bits(got), _bits(JR.relayout(jx, shape, src, dst)))
    np.testing.assert_array_equal(_bits(got), _bits(JR.relayout_ref(jx, shape, src, dst)))
    # round-trip through dense
    np.testing.assert_array_equal(_bits(TR.blocked_to_dense(got, shape)), _bits(td))


def test_paper_layout_strings():
    """P1/P2 workloads: MNM16N8 -> MNM8N8 at the paper's QK^T shape."""
    assert TR.parse_layout("MNM16N8") == JR.parse_layout("MNM16N8") == (16, 8)
    assert TR.parse_layout("MNM64N16") == (64, 16)
    for bad in ("N8M16", "MNM16", "mnm16n8"):
        with pytest.raises(ValueError):
            TR.parse_layout(bad)
        with pytest.raises(ValueError):
            JR.parse_layout(bad)
    shape = (2048, 192)
    jd, td = _pair(shape, "bfloat16", seed=1)
    jx, tx = JR.dense_to_blocked(jd, (16, 8)), TR.dense_to_blocked(td, (16, 8))
    got = TR.relayout_str(tx, shape, "MNM16N8", "MNM8N8")
    want = JR.relayout_str(jx, shape, "MNM16N8", "MNM8N8")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_identity_relayout():
    shape = (64, 64)
    _, td = _pair(shape, "float32", seed=2)
    x = TR.dense_to_blocked(td, (16, 8))
    got = TR.relayout(x, shape, (16, 8), (16, 8))
    assert torch.equal(got, x)


@pytest.mark.parametrize(
    "shape,src,dst",
    [((64, 32), (16, 8), (24, 8)), ((64, 32), (16, 8), (16, 6)), ((60, 32), (16, 8), (8, 8))],
)
def test_indivisible_raises_like_jax(shape, src, dst):
    M, N = shape
    jx = jnp.zeros((max(1, M // src[0]), max(1, N // src[1])) + src)
    tx = torch.zeros((max(1, M // src[0]), max(1, N // src[1])) + src)
    with pytest.raises(ValueError):
        JR.relayout(jx, shape, src, dst)
    with pytest.raises(ValueError, match="must divide"):
        TR.relayout(tx, shape, src, dst)


def test_wrong_input_shape_raises():
    with pytest.raises(ValueError, match="expected"):
        TR.relayout(torch.zeros(2, 2, 16, 8), (64, 32), (16, 8), (8, 8))


@pytest.mark.parametrize(
    "mi,ni,si,di",
    [(1, 1, 0, 1), (3, 2, 1, 2), (2, 5, 2, 3), (6, 1, 3, 0), (5, 3, 0, 2), (1, 6, 2, 1)],
)
def test_relayout_multiples_of_lcm(mi, ni, si, di):
    """Shapes that are random multiples of the lcm of both blockings."""
    src, dst = BLOCKS[si], BLOCKS[di]
    shape = (math.lcm(src[0], dst[0]) * mi, math.lcm(src[1], dst[1]) * ni)
    jd, td = _pair(shape, "float32", seed=mi * 7 + ni)
    got = TR.relayout(TR.dense_to_blocked(td, src), shape, src, dst)
    want = JR.relayout(JR.dense_to_blocked(jd, src), shape, src, dst)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_cpu_path_never_counts_a_launch_and_other_devices_raise():
    """The plain twin serves CPU tensors only: it is not a kernel launch,
    and a tensor on any other non-CUDA device is refused, not copied."""
    before = TR.relayout.launches
    TR.relayout(torch.zeros(4, 4, 16, 8), (64, 32), (16, 8), (8, 8))
    assert TR.relayout.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        TR.relayout(torch.zeros(4, 4, 16, 8, device="meta"), (64, 32), (16, 8), (8, 8))


@pytest.mark.parametrize(
    "elsize,sbn,dbn,ptr,unit",
    [(2, 8192, 8192, 0, 16), (4, 8, 8, 256, 16), (4, 8, 4, 256, 16), (2, 8, 4, 0, 8),
     (1, 8, 8, 0, 8), (4, 2, 8, 0, 8), (2, 16, 16, 2, 2), (8, 3, 5, 0, 8)],
)
def test_kernel_unit_choice(elsize, sbn, dbn, ptr, unit):
    """The CUDA kernel's load/store unit: the widest of 16/8/4/2/1 bytes
    that divides both block rows and the pointer alignment."""
    assert TR._unit_bytes(elsize, sbn, dbn, ptr) == unit


# ---- the CUDA wrapper's plan, on the CPU -------------------------------------


@pytest.mark.parametrize(
    "shape,src,dst,elsize,ptrs,route",
    [
        ((384, 8192), (1, 8192), (8, 8192), 2, (0, 0), "copy"),  # paged KV
        ((64, 96), (1, 96), (16, 96), 2, (512, 0), "copy"),  # other page sizes
        ((64, 48), (16, 8), (16, 8), 4, (0, 16), "copy"),  # equal blockings
        ((32, 64), (1, 8), (4, 64), 1, (0, 0), "copy"),  # both row-major
        ((2048, 192), (16, 8), (8, 8), 4, (0, 0), "staged"),  # the paper's layouts
        ((2048, 192), (16, 8), (64, 16), 4, (0, 0), "staged"),
        ((2048, 192), (8, 8), (16, 16), 4, (0, 0), "staged"),
        ((2048, 192), (16, 8), (8, 8), 1, (0, 0), "staged"),
        ((8192, 8192), (16, 8), (8, 8), 1, (0, 0), "staged"),
        ((8192, 4096), (16, 8), (64, 16), 2, (0, 0), "staged"),
        ((96, 24), (8, 3), (16, 1), 4, (0, 0), "staged"),
        ((64, 48), (8, 8), (16, 16), 8, (0, 0), "staged"),
        ((32, 64), (8, 8), (16, 16), 2, (2, 0), "direct"),  # misaligned source
        ((64, 48), (16, 8), (8, 8), 4, (0, 8), "direct"),  # misaligned destination
        ((384, 8192), (1, 8192), (8, 8192), 2, (2, 0), "direct"),  # misaligned copy
        ((16, 8192), (2, 8192), (8, 4096), 2, (0, 0), "direct"),  # 128 KiB super-tile
        ((8, 9), (8, 3), (8, 1), 1, (0, 0), "direct"),  # runs not a multiple of 16 B
    ],
)
def test_route_choice(shape, src, dst, elsize, ptrs, route):
    assert TR._route(shape, src, dst, elsize, *ptrs) == route
    plan = TR._plan(shape, src, dst, elsize, ptrs[0] % 16, ptrs[1] % 16, 132)
    assert plan.route == route and all(w[0] == TR.ROUTES.index(route) for _, w in plan.bands)


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


@pytest.mark.parametrize("M,N", [(1, 12), (4, 6), (6, 4), (8, 8), (2, 16)])
def test_identity_predicate_matches_the_permutation(M, N):
    """``_is_identity`` against the permutation itself, for every pair of
    blockings of small shapes."""
    x = torch.arange(M * N, dtype=torch.int32).reshape(M, N)
    blocks = [(a, b) for a in _divisors(M) for b in _divisors(N)]
    for src in blocks:
        xs = TR.dense_to_blocked(x, src)
        for dst in blocks:
            same = torch.equal(TR.relayout_ref(xs, (M, N), src, dst).reshape(-1), xs.reshape(-1))
            assert TR._is_identity((M, N), src, dst) == same, (src, dst)


@settings(max_examples=300)
@given(d=st.integers(1, 1 << 20), n=st.integers(0, (1 << 31) - 1))
def test_magic_divmod_matches_python(d, n):
    assert TR._magic_divmod(n, TR._magic(d)) == divmod(n, d)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 641, 1 << 20, (1 << 20) + 1, 6700417, (1 << 31) - 1])
def test_magic_divmod_at_the_edges(d):
    m = TR._magic(d)
    assert 0 < m[0] < 1 << 32
    for n in {0, 1, d - 1, d, d + 1, (1 << 31) - 1, (1 << 31) - 1 - d, ((1 << 31) - 1) // d * d}:
        if 0 <= n < 1 << 31:
            assert TR._magic_divmod(n, m) == divmod(n, d), n
    with pytest.raises(ValueError):
        TR._magic(0)


@pytest.mark.parametrize(
    "shape,src,dst,elsize",
    [
        ((1 << 17, 32768), (16, 8), (8, 8), 1),  # 4 GiB, staged
        ((65552, 32768), (16, 8), (8, 8), 1),  # just over 2^31 bytes
        ((3 * 8192 + 8, 65536), (1, 65536), (8, 65536), 2),  # copy, 3 GiB
        (((1 << 16) + 8, 1 << 15), (8, 3 * 8), (2, 1 << 15), 1),  # direct: a 192 KiB super-tile
    ],
)
def test_band_plan_over_2_31_bytes(shape, src, dst, elsize):
    """Transforms beyond 2^31 bytes are split into launches that each span
    at most 2^31 bytes, tile the tensor end to end, and start on a row
    that begins a block in both layouts."""
    M, N = shape
    plan = TR._plan(shape, src, dst, elsize, 0, 0, 132)
    total = M * N * elsize
    row = N * elsize
    ends = [off for off, _ in plan.bands] + [total]
    assert ends[0] == 0 and len(plan.bands) >= 2
    sizes = [b - a for a, b in zip(ends, ends[1:])]
    assert all(0 < s <= TR.LAUNCH_BYTES for s in sizes)
    if plan.route != "copy":
        step = math.lcm(src[0], dst[0])
        assert all(off % (row * step) == 0 for off in ends)
    for (off, words), size in zip(plan.bands, sizes):
        assert all(0 <= w < 1 << 32 for w in words)
        assert _emulated_extent(words, elsize) == size


def test_band_plan_refuses_rows_beyond_one_launch():
    with pytest.raises(ValueError, match="2\\^31"):
        TR._bands(64, 1 << 28, 16)


# A numpy model of what each route's kernel does with its plan words (the
# field order of CopyP / StagedP / DirectP in relayout.cu).
FIELDS = {
    "copy": ["route", "grid", "units", "tail"],
    "staged": ["route", "grid", "piece", "smem", "n_tiles", ("tiles_n",), "tile_row",
               "src_seg", "dst_seg", "src_stride", "dst_stride", "tile_bytes",
               ("src_seg16",), ("dst_seg16",), "piece_elems", "es_shift", ("dbn",),
               ("dbm",), ("nbd",), ("sbm",), ("sbn",), "nbs", "swz"],
    "direct": ["route", "grid", "unit", "total", ("dbn",), ("dbm",), ("nbd",), ("sbm",),
               ("sbn",), "nbs"],
}


def _fields(words):
    out, i = {}, 0
    for f in FIELDS[TR.ROUTES[words[0]]]:
        if isinstance(f, tuple):
            out[f[0]] = tuple(words[i:i + 3])
            i += 3
        else:
            out[f] = words[i]
            i += 1
    assert i == len(words)
    return out


def _div(n, magic):
    """``Div::divmod`` on numpy arrays (numerators < 2^31)."""
    mul, shift, d = (np.uint64(v) for v in magic)
    n = np.asarray(n, dtype=np.uint64)
    assert (n < 1 << 31).all()
    q = ((((n * mul) >> np.uint64(32)) + n) & np.uint64(0xFFFFFFFF)) >> shift
    return q.astype(np.int64), (n - q * d).astype(np.int64)


def _emulated_extent(words, elsize):
    f = _fields(words)
    if f["route"] == 0:
        return f["units"] * 16 + f["tail"]
    if f["route"] == 1:
        return f["n_tiles"] * f["tile_bytes"]
    return f["total"] * f["unit"]


def _emulate(words, src: np.ndarray, dst: np.ndarray):
    """Run one launch's plan on byte arrays; returns how often each dst
    byte was written."""
    f = _fields(words)
    written = np.zeros(dst.size, dtype=np.int64)
    if f["route"] == 0:
        n = f["units"] * 16 + f["tail"]
        dst[:n] = src[:n]
        written[:n] += 1
    elif f["route"] == 2:
        u = f["unit"]
        s, d = src.reshape(-1, u), dst.reshape(-1, u)
        o = np.arange(f["total"])
        t, jj = _div(o, f["dbn"])
        t, ii = _div(t, f["dbm"])
        bi, bj = _div(t, f["nbd"])
        i, j = bi * f["dbm"][2] + ii, bj * f["dbn"][2] + jj
        is_, ir = _div(i, f["sbm"])
        js, jr = _div(j, f["sbn"])
        d[o] = s[((is_ * f["nbs"] + js) * f["sbm"][2] + ir) * f["sbn"][2] + jr]
        np.add.at(written.reshape(-1, u), o, 1)
    else:
        tb, G = f["tile_bytes"], f["piece"]
        stage = f["smem"] // 2  # one stage of the ring: every address a tile touches
        assert f["smem"] == 2 * stage and stage % 128 == 0 and 0 <= stage - tb < 128
        assert tb % 16 == 0
        tr, tc = _div(np.arange(f["n_tiles"])[:, None], f["tiles_n"])
        c = np.arange(tb // 16)[None, :]
        seg, w = _div(c, f["src_seg16"])
        gaddr = tr * f["tile_row"] + tc * f["src_seg"] + seg * f["src_stride"] + w * 16
        saddr = np.broadcast_to(TR._swizzle(c * 16, f["swz"]), gaddr.shape)
        smem = np.zeros((f["n_tiles"], stage), dtype=np.uint8)
        k = np.arange(16)
        rows = np.arange(f["n_tiles"])[:, None, None]
        smem[rows, saddr[..., None] + k] = src[gaddr[..., None] + k]
        P = 16 // G
        q = np.arange(tb // G)[None, :]  # piece index = u * P + q
        e = q * f["piece_elems"]
        t, jj = _div(e, f["dbn"])
        t, ii = _div(t, f["dbm"])
        r, bj = _div(t, f["nbd"])
        i, j = r * f["dbm"][2] + ii, bj * f["dbn"][2] + jj
        is_, ir = _div(i, f["sbm"])
        js, jr = _div(j, f["sbn"])
        s = ((is_ * f["nbs"] + js) * f["sbm"][2] + ir) * f["sbn"][2] + jr
        sb = TR._swizzle(s << f["es_shift"], f["swz"])
        assert (sb % G == 0).all()
        g = np.arange(G)
        pieces = smem[rows, np.broadcast_to(sb, (f["n_tiles"], sb.shape[1]))[..., None] + g]
        units = pieces.reshape(f["n_tiles"], -1, 16)
        u = np.arange(tb // 16)[None, :]
        seg, w = _div(u, f["dst_seg16"])
        oaddr = tr * f["tile_row"] + tc * f["dst_seg"] + seg * f["dst_stride"] + w * 16
        dst[oaddr[..., None] + k] = units
        np.add.at(written, (oaddr[..., None] + k).reshape(-1), 1)
        assert P * G == 16
    return written


ELSIZE_DTYPES = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32, 8: torch.float64}


@pytest.mark.parametrize("elsize", [1, 2, 4, 8])
@pytest.mark.parametrize(
    "shape,src,dst,ptrs,route",
    [
        ((64, 96), (1, 96), (8, 96), (0, 0), "copy"),
        ((48, 40), (16, 8), (16, 8), (0, 0), "copy"),
        ((256, 192), (16, 8), (8, 8), (0, 0), "staged"),
        ((256, 192), (16, 8), (64, 16), (0, 0), "staged"),
        ((128, 64), (8, 8), (16, 16), (0, 0), "staged"),
        ((256, 192), (64, 16), (16, 8), (0, 0), "staged"),
        ((128, 64), (16, 8), (8, 16), (0, 0), "staged"),
        ((96, 48), (8, 6), (16, 2), (0, 0), "staged"),
        ((64, 48), (8, 8), (16, 16), (8, 0), "direct"),
        ((32, 24), (8, 3), (16, 1), (4, 4), "direct"),
        ((16, 8192), (2, 8192), (8, 4096), (0, 0), "direct"),
    ],
)
def test_plan_emulated_matches_ref(shape, src, dst, ptrs, route, elsize):
    """Every route's plan words, run through the numpy model of its
    kernel, give relayout_ref's bytes, each destination byte written once."""
    ptrs = tuple(max(p, elsize) if p else 0 for p in ptrs)  # aligned to the element
    plan = TR._plan(shape, src, dst, elsize, ptrs[0] % 16, ptrs[1] % 16, 132)
    want_route = route if not (route != "copy" and TR._is_identity(shape, src, dst)) else "copy"
    assert plan.route == want_route
    _check_emulated(plan, shape, src, dst, elsize)


# Staged tiles whose last 128-byte line is partial, with a swizzle other
# than the identity: the swizzled last line must stay inside its stage.
PARTIAL_LINE = [
    ((9684, 28), (4, 4), (1, 4), 4),  # tile 36 x 28: 31.5 lines
    ((1296, 208), (2, 1), (1, 16), 1),  # tile 4 x 208: 6.5 lines
    ((432, 208), (1, 16), (2, 4), 2),  # tile 18 x 16: 4.5 lines
    ((144, 208), (2, 1), (2, 4), 8),  # tile 2 x 52: 6.5 lines
]


@pytest.mark.parametrize("shape,src,dst,elsize", PARTIAL_LINE)
def test_plan_emulated_matches_ref_partial_line(shape, src, dst, elsize):
    """The staged plan of such a tile rounds each stage up to whole lines,
    and its emulation is still bit-exact."""
    plan = TR._plan(shape, src, dst, elsize, 0, 0, 132)
    TM, TN = plan.info["tile"]
    assert plan.route == "staged" and plan.info["swizzle"] != 0
    assert (TM * TN * elsize) % 128 != 0
    _check_emulated(plan, shape, src, dst, elsize)


def _check_emulated(plan, shape, src, dst, elsize):
    """``plan``'s launches, run through :func:`_emulate`, give
    relayout_ref's bytes, each destination byte written once."""
    dense = torch.from_numpy(np.random.default_rng(elsize).integers(
        -100, 100, size=shape).astype(np.int8)).to(ELSIZE_DTYPES[elsize])
    x = TR.dense_to_blocked(dense, src)
    want = TR.relayout_ref(x, shape, src, dst).contiguous().view(torch.uint8).numpy().reshape(-1)
    xs = x.contiguous().view(torch.uint8).numpy().reshape(-1)
    out = np.zeros_like(want)
    written = np.zeros(out.size, dtype=np.int64)
    ends = [off for off, _ in plan.bands] + [out.size]
    for (off, words), end in zip(plan.bands, ends[1:]):
        written[off:end] += _emulate(words, xs[off:end], out[off:end])
    np.testing.assert_array_equal(out, want)
    assert (written == 1).all()


@pytest.mark.parametrize(
    "shape,src,dst,elsize",
    [((4096, 192), (16, 8), (8, 8), 4), ((1024, 384), (8, 8), (16, 16), 2),
     ((512, 96), (16, 8), (8, 8), 1), ((512, 16), (16, 8), (64, 16), 8)],
)
def test_plan_bands_emulated(shape, src, dst, elsize, monkeypatch):
    """With a small launch extent, every route splits into several bands,
    and the bands together still give relayout_ref's bytes."""
    monkeypatch.setattr(TR, "LAUNCH_BYTES", 1 << 14)
    TR._plan.cache_clear()
    try:
        for s, d in ((src, dst), ((1, shape[1]), (8, shape[1]))):
            for ptrs in ((0, 0), (elsize, 0)):
                plan = TR._plan(shape, s, d, elsize, *ptrs, 132)
                assert len(plan.bands) > 1
                dense = torch.from_numpy(np.random.default_rng(3).integers(
                    -100, 100, size=shape).astype(np.int8)).to(ELSIZE_DTYPES[elsize])
                x = TR.dense_to_blocked(dense, s)
                want = TR.relayout_ref(x, shape, s, d).contiguous().view(torch.uint8)
                want = want.numpy().reshape(-1)
                xs = x.contiguous().view(torch.uint8).numpy().reshape(-1)
                out = np.zeros_like(want)
                ends = [off for off, _ in plan.bands] + [out.size]
                for (off, words), end in zip(plan.bands, ends[1:]):
                    assert end - off <= 1 << 14
                    _emulate(words, xs[off:end], out[off:end])
                np.testing.assert_array_equal(out, want)
    finally:
        TR._plan.cache_clear()


@pytest.mark.parametrize(
    "shape,src,dst,elsize",
    [((2048, 192), (16, 8), (8, 8), 4), ((2048, 192), (16, 8), (64, 16), 4),
     ((2048, 192), (8, 8), (16, 16), 4), ((2048, 192), (16, 8), (8, 8), 1),
     ((8192, 8192), (16, 8), (8, 8), 1), ((8192, 4096), (16, 8), (64, 16), 2)],
)
def test_staged_gather_is_free_of_bank_conflicts(shape, src, dst, elsize):
    """At the paper's layouts and the large cases of chip_smoke.py, the
    chosen swizzle leaves each bank one word per phase, and every 16-byte
    destination unit is gathered as one 16-byte piece."""
    plan = TR._plan(shape, src, dst, elsize, 0, 0, 132)
    assert plan.route == "staged"
    assert plan.info["bank_conflicts"] == 1 and plan.info["piece"] == 16


def test_cpu_calls_leave_the_route_counters_alone():
    before = dict(TR.relayout.launches_by_route)
    TR.relayout(torch.zeros(4, 4, 16, 8), (64, 32), (16, 8), (8, 8))
    TR.relayout(torch.zeros(64, 1, 1, 32), (64, 32), (1, 32), (8, 32))
    assert TR.relayout.launches_by_route == before
    assert set(before) == {"copy", "staged", "direct"}
