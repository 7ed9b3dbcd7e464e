"""The port's cell layer (``repro_torch.launch.steps.build_cell``,
``Cell``, ``VARIANTS``) against ``repro.launch.steps``.

1. Every applicable (arch × shape) cell at full width, and every
   ``VARIANTS`` entry on llama3-8b ``train_4k``, on a 4-rank data mesh:
   the config, the resolved step knobs, the args' paths, shapes and
   dtypes (the port's on the ``meta`` device: nothing allocated; JAX's
   ``ShapeDtypeStruct``s), the in and out specs (JAX's ``NamedSharding``
   specs) and ``donate_argnums`` are equal. Exact.
2. A step knob passed against a variant's raises the same
   ``ValueError`` in both.
3. For one arch of each family, the three steps of the smoke cells (JAX's
   smoke shapes) run on the same weights (carried across by
   ``models.convert``) and the same inputs (the port's concrete cell
   args): the train step's loss within 1e-3, grad norm within 1e-2
   relative and first AdamW moment (0.1 × the clipped grads) within 5%
   of each leaf's max with cosine >= 0.999 (jamba's 8 bf16 layers: 25%
   and 0.99, as ``tests/test_torch_mamba2.py`` holds its grads), every
   param moved; prefill logits within 5% of the logit scale and cache
   rows within 0.05 (the bounds of ``tests/test_torch_model.py``);
   decode tokens equal except at near ties of JAX's logits, and its
   cache within 0.05. MoE calls are routed as JAX routed them
   (``tests/_jax_moe_routing.py``), with ``remat="none"`` so each MoE
   layer routes once per step.

   jamba's prefill and decode cells run with both packages'
   ``COMPUTE_DTYPE`` set to f32: through its 8 bf16 layers the deepest
   SSM state of the 32-token smoke prompt drifts 6.3% of its scale (the
   two packages round the same bf16 graph at different places), past
   the cache bound, while in f32 the logits agree within 3e-6 of their
   scale. So there the logits are held within 1e-4 of their scale and
   each cache leaf within 4e-3 of its (one bf16 rounding, 2^-8, of the
   K/V and conv rows the caches store). JAX's f32 decode cannot write
   its bf16 cache (ROADMAP §3), so the decode cell's cache goes to both
   cast to f32 (measured: logits 8.7e-7, the conv rows 2.6e-3, the
   rest 2.6e-6 of their scales). Its bf16 prefill and decode are held
   in ``tests/test_torch_model.py`` at its 16-token prompts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.spec import P  # noqa: E402
from repro_torch.tree import leaves, map_tree  # noqa: E402
from repro_torch.tree import paths as tree_paths  # noqa: E402

from _jax_moe_routing import NEAR_TIE, flip_margins, record_jax_routing  # noqa: E402
from _moe_routing import routing_as  # noqa: E402

CELLS = [(a, s) for a in JC.ARCHS for s in JC.SHAPES if JC.applicable(a, s)[0]]
KNOBS = ("num_chains", "ar_algo", "compress_grads", "bucket_bytes", "topology")

# JAX's smoke shapes (tests/test_steps_and_dryrun.py)
SMOKE_SHAPES = {
    "train": ("train_smoke", "train", 32, 4),
    "prefill": ("prefill_smoke", "prefill", 32, 2),
    "decode": ("decode_smoke", "decode", 64, 4),
}
FAMILIES = ["yi-6b", "deepseek-moe-16b", "deepseek-v2-lite-16b", "mamba2-2.7b",
            "jamba-v0.1-52b", "qwen2-vl-7b", "whisper-tiny"]
PINNED = {"deepseek-moe-16b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"}
LOGIT_REL, CACHE_TOL = 5e-2, 5e-2
GRAD_BOUNDS = {"jamba-v0.1-52b": (0.25, 0.99)}
DEEP = {"jamba-v0.1-52b": {"near_tie": 2e-2}}
F32_LOGIT_REL, F32_CACHE_REL = 1e-4, 4e-3


def _arg_tree(tree) -> dict:
    """{path: (shape, dtype name)} of a port tree of tensors."""
    return {"".join(f"[{k!r}]" for k in p): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tree_paths(tree)}


def _jax_arg_tree(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _spec_tree(tree) -> dict:
    return {"".join(f"[{k!r}]" for k in p): (None if s is None else tuple(s))
            for p, s in tree_paths(tree)}


def _jax_spec_tree(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding) or x is None)
    return {jax.tree_util.keystr(p): (None if s is None else tuple(s.spec)) for p, s in flat}


def _same_cell(got: TS.Cell, want: JS.Cell) -> None:
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert vars(got.shape) == vars(want.shape)
    assert {k: getattr(got, k) for k in KNOBS} == {k: getattr(want, k) for k in KNOBS}
    assert got.donate_argnums == want.donate_argnums
    assert all(t.device.type == "meta" for t in leaves(got.args))
    assert _arg_tree(got.args) == _jax_arg_tree(want.args)
    assert all(s is None or isinstance(s, P) for s in leaves([got.in_specs, got.out_specs]))
    assert _spec_tree(got.in_specs) == _jax_spec_tree(want.in_shardings)
    assert _spec_tree(got.out_specs) == _jax_spec_tree(want.out_shardings)


def _meshes():
    return make_host_mesh(data=4), jax.sharding.AbstractMesh((4, 1), ("data", "model"))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_full_width_cell_matches_jax(arch, shape):
    tmesh, jmesh = _meshes()
    got = TS.build_cell(arch, shape, tmesh, collectives="torrent")
    want = JS.build_cell(arch, shape, jmesh, collectives="torrent")
    _same_cell(got, want)
    assert got.mesh is tmesh and callable(got.step_fn)


def test_variants_copy_jax():
    assert TS.VARIANTS == JS.VARIANTS


@pytest.mark.parametrize("variant", sorted(JS.VARIANTS))
def test_variant_cell_matches_jax(variant):
    tmesh, jmesh = _meshes()
    got = TS.build_cell("llama3-8b", "train_4k", tmesh, collectives="torrent", variant=variant)
    want = JS.build_cell("llama3-8b", "train_4k", jmesh, collectives="torrent", variant=variant)
    _same_cell(got, want)
    assert TS.VARIANTS == JS.VARIANTS  # the knobs were popped from a copy


CONFLICTS = [
    ("k2", {"num_chains": 4}, None),
    ("pin-rsag", {"ar_algo": "rotation"}, {"ar_algo": "rs_ag"}),
    ("pin-exact", {"compress_grads": True}, {"compress_grads": False}),
    ("bucketed", {"bucket_bytes": 1 << 20}, None),
    ("tiered", {"topology": "pods=4"}, None),
]


@pytest.mark.parametrize("variant,explicit,extra", CONFLICTS)
def test_knob_against_variant_raises_like_jax(variant, explicit, extra, monkeypatch):
    """The five conflicts: each step knob passed explicitly against the
    value its variant pins raises the same ``ValueError``; the knob's
    non-conflicting default does not."""
    if extra is not None:
        monkeypatch.setitem(JS.VARIANTS, variant, extra)
        monkeypatch.setitem(TS.VARIANTS, variant, extra)
    tmesh, jmesh = _meshes()
    with pytest.raises(ValueError) as want:
        JS.build_cell("llama3-8b", "train_4k", jmesh, collectives="torrent", variant=variant,
                      **explicit)
    with pytest.raises(ValueError) as got:
        TS.build_cell("llama3-8b", "train_4k", tmesh, collectives="torrent", variant=variant,
                      **explicit)
    assert str(got.value) == str(want.value)
    assert TS.build_cell("llama3-8b", "train_4k", tmesh, collectives="torrent",
                         variant=variant).cfg == TC.get_config("llama3-8b")


def test_knobs_without_torrent_raise_like_jax():
    tmesh, jmesh = _meshes()
    for variant in ("tiered", "int8-ar", "bucketed"):
        with pytest.raises(ValueError) as want:
            JS.build_cell("llama3-8b", "train_4k", jmesh, variant=variant)
        with pytest.raises(ValueError) as got:
            TS.build_cell("llama3-8b", "train_4k", tmesh, variant=variant)
        assert str(got.value) == str(want.value)


def test_concrete_cells_are_seeded():
    """On a real device the args are concrete and the same from call to
    call: params from seed 0, tokens in [0, vocab), text positions."""
    mesh = make_host_mesh(data=2)
    a = TS.build_cell("qwen2-vl-7b", "train_4k", mesh, smoke=True, device="cpu")
    b = TS.build_cell("qwen2-vl-7b", "train_4k", mesh, smoke=True, device="cpu")
    assert all(x.device.type == "cpu" for x in leaves(a.args))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.args), leaves(b.args)))
    batch = a.args[2]
    assert batch["embeds"].dtype == torch.bfloat16 and batch["embeds"].std() > 0.5
    assert int(batch["labels"].min()) >= 0 and int(batch["labels"].max()) < a.cfg.vocab_size
    assert torch.equal(batch["positions"][2, 1], torch.arange(4096, dtype=torch.int32))
    assert _arg_tree(a.args) == _arg_tree(
        TS.build_cell("qwen2-vl-7b", "train_4k", mesh, smoke=True).args)


# -- the three steps of the smoke cells, against JAX's --------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _to_jax(tree):
    """JAX arrays with the values of a port tree, copied: JAX may alias
    a numpy buffer, and the port's decode writes its cache in place."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy().copy())
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return one(tree)


def _close_to_scale(got, want, rel):
    want = _np(want)
    err, scale = np.abs(_np(got) - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _caches_close(arch, got, want, dtypes=True):
    jl, tl = jax.tree.leaves(want), leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert not dtypes or str(t.dtype).removeprefix("torch.") == j.dtype.name
        if arch in DEEP:  # run in f32
            _close_to_scale(t, j, F32_CACHE_REL)
        else:
            np.testing.assert_allclose(_np(t), _np(j), atol=CACHE_TOL, rtol=CACHE_TOL)


@pytest.fixture
def smoke_shapes(monkeypatch):
    for name, kind, seq, batch in SMOKE_SHAPES.values():
        monkeypatch.setitem(JC.SHAPES, name, JC.Shape(name, kind, seq, batch))
        monkeypatch.setitem(TC.SHAPES, name, TC.Shape(name, kind, seq, batch))


def _pinning(arch, monkeypatch):
    """JAX's recorded routing and a context that routes the port's MoE
    calls made in it as JAX's calls chose (a no-op for a dense arch)."""
    if arch not in PINNED:
        return [], _nothing
    seen = record_jax_routing(monkeypatch)

    def pinned():
        return routing_as(torch.from_numpy(np.array(e, np.int64)) for _, e in seen)

    return seen, pinned


class _nothing:
    def __enter__(self):
        return []

    def __exit__(self, *exc):
        return False


def _check_flips(arch, seen, flips):
    jax.effects_barrier()
    if arch in PINNED:
        near_tie = DEEP.get(arch, {}).get("near_tie", NEAR_TIE)
        assert len(flips) == len(seen) > 0
        assert all(m <= near_tie for m in flip_margins(seen, flips))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cell_steps_match_jax(arch, kind, smoke_shapes, monkeypatch):
    name = SMOKE_SHAPES[kind][0]
    remat = "none" if arch in PINNED else "dots"
    logit_rel = LOGIT_REL
    if arch in DEEP and kind != "train":
        monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
        logit_rel = F32_LOGIT_REL
    jcell = JS.build_cell(arch, name, jax_host_mesh(model=1), smoke=True, remat=remat)
    tcell = TS.build_cell(arch, name, make_host_mesh(data=1), smoke=True, remat=remat,
                          device="cpu")
    assert _arg_tree(tcell.args) == _jax_arg_tree(jcell.args)
    jparams = JT.model_init(jax.random.PRNGKey(0), jcell.cfg)
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    seen, pinned = _pinning(arch, monkeypatch)
    step = jax.jit(jcell.step_fn)

    if kind == "train":
        batch = tcell.args[2]
        jp, jo, jm = step(jparams, JA.init(jparams), _to_jax(batch))
        init = [p.clone() for p in leaves(tparams)]
        with pinned() as flips:
            tp, to, tm = tcell.step_fn(tparams, adamw.init(tparams), batch)
        _check_flips(arch, seen, flips)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-3
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < 1e-2
        rel, cos = GRAD_BOUNDS.get(arch, (5e-2, 0.999))
        for t, j in zip(leaves(to["mu"]), jax.tree.leaves(jo["mu"])):
            a, g = np.asarray(j, np.float64), t.double().numpy()
            assert a.shape == g.shape and np.isfinite(g).all()
            assert np.abs(a - g).max() <= rel * np.abs(a).max()
            if np.abs(a).max() > 0:
                assert (a * g).sum() / np.sqrt((a * a).sum() * (g * g).sum()) >= cos
        assert all(not torch.equal(a, b) for a, b in zip(init, leaves(tp)))
        assert int(to["step"]) == int(jo["step"]) == 1
    elif kind == "prefill":
        batch = tcell.args[1]
        jl, jc = step(jparams, _to_jax(batch))
        with pinned() as flips:
            tl, tc = tcell.step_fn(tparams, batch)
        _check_flips(arch, seen, flips)
        assert tl.shape == jl.shape == (2, jcell.cfg.vocab_size)
        _close_to_scale(tl, jl, logit_rel)
        _caches_close(arch, tc, jc)
    else:
        tokens, pos, cache = tcell.args[1:]
        if arch in DEEP:  # run in f32
            cache = map_tree(lambda x: x.float(), cache)
        jcache = _to_jax(cache)
        jt, jc = jax.block_until_ready(
            step(jparams, _to_jax(tokens), jnp.asarray(pos.numpy().copy()), jcache))
        with pinned() as flips:
            tt, tc = tcell.step_fn(tparams, tokens, pos, cache)
        _check_flips(arch, seen, flips)
        assert tt.dtype == torch.int32 and tt.shape == (4,)
        differ = np.flatnonzero(tt.numpy() != np.asarray(jt))
        if differ.size:  # only where JAX's logits nearly tie
            logits, _ = JT.decode_step(jparams, jcell.cfg, _to_jax(tokens),
                                       jnp.asarray(pos.numpy()), jcache)
            logits = np.asarray(logits, np.float32)
            gap = logits[differ, np.asarray(jt)[differ]] - logits[differ, tt.numpy()[differ]]
            assert (gap <= logit_rel * np.abs(logits).max()).all(), gap
        # JAX's mamba decode stores its conv window in bf16 whatever the
        # cache it was given; the port's writes into the f32 cast in place
        _caches_close(arch, tc, jc, dtypes=arch not in DEEP)

