"""The port's relayout entry points against the JAX relayout kernel
(Pallas, interpret mode) and ``relayout_ref``.

On the CPU ``repro_torch.kernels.relayout.relayout`` runs its plain twin;
it must be bit-exact against both JAX paths for f32 and bf16 (compared as
``uint16``) and raise the same ``ValueError``s. The CUDA kernel itself is
held against the same twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

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
