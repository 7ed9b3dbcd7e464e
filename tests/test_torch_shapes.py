"""The port's assigned shapes (``repro_torch.configs.shapes``), batch
layouts (``repro_torch.parallel.sharding.batch_pspecs``) and the DP
split that follows them (``collectives.split_batch``) against the JAX
package: every arch × shape's applicability and input specs (the port's
meta tensors against JAX's ``ShapeDtypeStruct``s: keys, shapes and
dtypes, the decode cache included), and each batch leaf's spec against
JAX's ``PartitionSpec`` and the DP split along the position of the
batch axes in it. These are exact: shapes and layouts, no arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.parallel import sharding as JSh  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.collectives import split_batch  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.tree import paths as tree_paths  # noqa: E402


def test_shapes_and_applicability_match_jax():
    assert {k: vars(v) for k, v in TC.SHAPES.items()} == {
        k: vars(v) for k, v in JC.SHAPES.items()}
    assert TC.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS
    for arch in JC.ARCHS:
        for shape in JC.SHAPES:
            assert TC.applicable(arch, shape) == JC.applicable(arch, shape)


def _spec_tree(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype.name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_input_specs_match_jax(arch):
    for name in JC.SHAPES:
        want = JC.input_specs(JC.get_config(arch), JC.SHAPES[name])
        got = TC.input_specs(TC.get_config(arch), TC.SHAPES[name])
        assert sorted(got) == sorted(want), name
        if "max_seq" in want:
            assert got["max_seq"] == want["max_seq"]
        tensors = {k: v for k, v in got.items() if k != "max_seq"}
        assert all(t.device.type == "meta" for t in leaves(tensors))
        assert [("".join(f"[{k!r}]" for k in p), tuple(t.shape),
                 str(t.dtype).removeprefix("torch."))
                for p, t in tree_paths(tensors)] == _spec_tree(
            {k: v for k, v in want.items() if k != "max_seq"}), name


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_batch_axes_match_jax_batch_pspecs(arch):
    for name in ("train_4k", "prefill_32k"):
        want = JSh.batch_pspecs(JC.get_config(arch), JC.SHAPES[name])
        got = sharding.batch_pspecs(TC.get_config(arch), TC.SHAPES[name])
        assert {k: tuple(spec) for k, spec in got.items()} == {
            k: tuple(spec) for k, spec in want.items()}
        assert {k: sharding.batch_axis(spec) for k, spec in got.items()} == {
            k: tuple(spec).index(JSh.BATCH_AXES) for k, spec in want.items()}
    with pytest.raises(ValueError):
        sharding.batch_pspecs(TC.get_config(arch), TC.SHAPES["decode_32k"])


def test_split_batch_keeps_each_ranks_position_streams():
    """DP = 3 over a vision-language batch of 6 rows: rank r's
    ``positions[:, rows]`` belong to its ``embeds`` rows, all three
    streams of them. (Splitting positions along axis 0, as a batch
    without ``batch_specs`` is split, would hand each rank one stream.)"""
    B, S, d = 6, 5, 4
    embeds = torch.arange(B * S * d, dtype=torch.float32).reshape(B, S, d)
    positions = torch.arange(3 * B * S, dtype=torch.int32).reshape(3, B, S)
    labels = torch.arange(B * S, dtype=torch.int32).reshape(B, S)
    batch = {"embeds": embeds, "positions": positions, "labels": labels}
    specs = sharding.batch_pspecs(TC.get_smoke_config("qwen2-vl-7b"), TC.SHAPES["train_4k"])
    for r in range(3):
        part = split_batch(batch, 3, r, specs)
        rows = slice(2 * r, 2 * r + 2)
        assert torch.equal(part["embeds"], embeds[rows])
        assert torch.equal(part["positions"], positions[:, rows])
        assert torch.equal(part["labels"], labels[rows])
        wrong = split_batch(batch, 3, r)["positions"]
        assert wrong.shape == (1, B, S) and not torch.equal(wrong, part["positions"])
    with pytest.raises(ValueError, match="not divisible"):
        split_batch(batch, 4, 0, specs)
    np.testing.assert_array_equal(  # axis 0 where no specs are given
        split_batch({"tokens": labels}, 3, 1)["tokens"].numpy(), labels[2:4].numpy())
