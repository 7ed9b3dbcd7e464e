"""The port's int8 wire numerics (``repro_torch.runtime.compression``)
against ``repro.runtime.compression`` and the numpy twin
``chainwrite_ref._quantize_ref``: bit for bit — the int8 frame, the f32
scale's bits and the dequantized values — on zeros, ±max, half-way
values, tiny and subnormal inputs and random tensors over 60 decades;
and ``ErrorFeedback`` round trips against JAX's. Tolerance: none, every
comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.chainwrite_ref import _dequantize_ref, _quantize_ref  # noqa: E402
from repro.runtime import compression as J  # noqa: E402

from repro_torch.runtime import compression as TC  # noqa: E402

_jq = jax.jit(J.quantize)
F32 = np.finfo(np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _cases() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    halfway = np.arange(-127, 128, dtype=np.float32) + 0.5  # max 127.5
    halfway = np.concatenate([halfway, [128.0, -128.0]]).astype(np.float32)  # scale 1.0
    return {
        "zeros": np.zeros(16, np.float32),
        "neg_zeros": -np.zeros(7, np.float32),
        "plus_minus_max": np.array([F32.max, -F32.max, 1.0, -0.0], np.float32),
        "halfway": halfway,
        "one_hot": np.eye(1, 33, 5, dtype=np.float32)[0] * -3.0,
        "tiny": np.array([1e-30, -2e-31, 7e-32, 1e-12, -5e-13], np.float32),
        "subnormal": np.array([1e-40, -3e-41, 1.4e-45, 0.0, 5e-39], np.float32),
        "scale_near_floor": (rng.standard_normal(64) * 1e-10).astype(np.float32),
        "ramp": np.linspace(-1.0, 1.0, 255, dtype=np.float32),
        "ties_at_scale": (np.arange(-20, 21, dtype=np.float32) + 0.5) * np.float32(0.25),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_quantize_edge_cases_bitexact(name):
    x = _cases()[name]
    q, s = TC.quantize(torch.from_numpy(x))
    qr, sr = _quantize_ref(x)
    jq, js = _jq(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert np.array_equal(q.numpy(), qr) and np.array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s.item()) == _bits(sr) == _bits(np.asarray(js))
    d = TC.dequantize(q, s).numpy()
    assert np.array_equal(_bits(d), _bits(_dequantize_ref(qr, sr)))
    assert np.array_equal(_bits(d), _bits(np.asarray(J.dequantize(jq, js))))


@pytest.mark.parametrize("scale_pow", range(-30, 31, 6))
@pytest.mark.parametrize("shape", [(257,), (13, 7), (2, 3, 64)])
def test_quantize_random_bitexact(scale_pow, shape):
    rng = np.random.default_rng(abs(scale_pow) * 7 + len(shape))
    x = (rng.standard_normal(shape) * 10.0 ** scale_pow).astype(np.float32)
    q, s = TC.quantize(torch.from_numpy(x))
    qr, sr = _quantize_ref(x)
    jq, js = _jq(jnp.asarray(x))
    assert np.array_equal(q.numpy(), qr) and np.array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s.item()) == _bits(sr) == _bits(np.asarray(js))
    # the masked scale keeps 17 significant bits: every q * scale is exact
    assert _bits(sr) & 0x7F == 0


def test_quantize_rows_is_per_row_quantize():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4, 9)).astype(np.float32)
    x[1] *= 1e-20
    x[2] = 0.0
    x[3, 0, 0] = 1e30
    q, s = TC.quantize_rows(torch.from_numpy(x))
    assert q.shape == x.shape and s.shape == (6,)
    for d in range(6):
        qr, sr = _quantize_ref(x[d])
        assert np.array_equal(q[d].numpy(), qr) and _bits(s[d].item()) == _bits(sr)
    assert torch.equal(TC.dequantize_rows(q, s)[3], TC.dequantize(q[3], s[3]))


def test_quantize_casts_other_floats_to_f32():
    x = torch.tensor([1.5, -2.25, 100.0], dtype=torch.bfloat16)
    q, s = TC.quantize(x)
    qr, sr = _quantize_ref(x.float().numpy())
    assert np.array_equal(q.numpy(), qr) and _bits(s.item()) == _bits(sr)


def test_non_finite_inputs_poison_the_scale():
    for bad in (np.inf, np.nan):
        _, s = TC.quantize(torch.tensor([1.0, bad, -2.0]))
        assert not np.isfinite(s.item())


def test_error_feedback_round_trips_match_jax():
    """Three EF-SGD rounds on a two-leaf tree: the (q, scale) frames,
    the decompressed grads and the carried residuals equal JAX's bit
    for bit every round."""
    rng = np.random.default_rng(11)
    tree = {"w": rng.standard_normal((8, 5)).astype(np.float32),
            "b": [rng.standard_normal((3,)).astype(np.float32) * 1e-3]}
    t_res = TC.ErrorFeedback.init({"w": torch.zeros(8, 5), "b": [torch.zeros(3)]})
    j_res = J.ErrorFeedback.init({"w": jnp.zeros((8, 5)), "b": [jnp.zeros((3,))]})
    for rnd in range(3):
        g = {"w": tree["w"] * (rnd + 1), "b": [tree["b"][0] - rnd]}
        tq, t_res = TC.ErrorFeedback.compress(
            {"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}, t_res)
        jq, j_res = J.ErrorFeedback.compress(
            {"w": jnp.asarray(g["w"]), "b": [jnp.asarray(g["b"][0])]}, j_res)
        for tpair, jpair in ((tq["w"], jq["w"]), (tq["b"][0], jq["b"][0])):
            assert np.array_equal(tpair[0].numpy(), np.asarray(jpair[0]))
            assert _bits(tpair[1].item()) == _bits(np.asarray(jpair[1]))
        td = TC.ErrorFeedback.decompress(tq)
        jd = J.ErrorFeedback.decompress(jq)
        assert np.array_equal(_bits(td["w"].numpy()), _bits(np.asarray(jd["w"])))
        for tr, jr in ((t_res["w"], j_res["w"]), (t_res["b"][0], j_res["b"][0])):
            assert np.array_equal(_bits(tr.numpy()), _bits(np.asarray(jr)))
