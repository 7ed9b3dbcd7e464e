"""The port's partition specs against the JAX package's: the param specs
(``parallel.sharding.param_pspecs`` at TP 16 and 4, full width, every
arch; the port's params on the ``meta`` device against
``jax.eval_shape``), the decode-cache specs, ZeRO-1 optimizer specs,
batch specs, the error-feedback residual specs, ``launch.steps._sanitize``
and ``parallel.hints.resolve_spec``; then the JAX package's own spec
tests, ported. Trees are compared leaf by leaf through their paths
(dict keys and list indices), each spec against ``tuple(jax_spec)``.
Specs are exact: no tolerance.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import collectives as JCol  # noqa: E402
from repro.parallel import hints as JH  # noqa: E402
from repro.parallel import sharding as JSh  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.parallel import collectives as TCol  # noqa: E402
from repro_torch.parallel import hints as TH  # noqa: E402
from repro_torch.parallel import sharding as TSh  # noqa: E402
from repro_torch.parallel.spec import P  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.tree import paths as tree_paths  # noqa: E402


def jax_flat(tree) -> dict:
    """{path: tuple(spec)} of a JAX spec tree (``None`` leaves kept)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP) or x is None)
    return {jax.tree_util.keystr(p): (None if s is None else tuple(s)) for p, s in flat}


def port_flat(tree) -> dict:
    out = {}
    for p, s in tree_paths(tree):
        assert s is None or isinstance(s, P), (p, s)
        out["".join(f"[{k!r}]" for k in p)] = None if s is None else tuple(s)
    return out


@pytest.fixture(scope="module", params=JC.ARCHS)
def arch_params(request):
    """An arch's full-width param tree in both packages, allocated by
    neither."""
    arch = request.param
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jshape = jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0), jcfg))
    tshape = TT.model_init(torch.Generator(), tcfg, device="meta")
    assert all(t.device.type == "meta" for t in leaves(tshape))
    return arch, jcfg, tcfg, jshape, tshape


@pytest.mark.parametrize("tp", [16, 4])
def test_param_pspecs_match_jax(arch_params, tp):
    arch, jcfg, tcfg, jshape, tshape = arch_params
    want = jax_flat(JSh.param_pspecs(jshape, jcfg, tp=tp))
    got = port_flat(TSh.param_pspecs(tshape, tcfg, tp=tp))
    assert got == want, arch
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("data", [16, 4])
def test_opt_pspecs_and_zero1_match_jax(arch_params, data):
    arch, jcfg, tcfg, jshape, tshape = arch_params
    jspecs = JSh.param_pspecs(jshape, jcfg, tp=16)
    tspecs = TSh.param_pspecs(tshape, tcfg, tp=16)
    want = JSh.opt_pspecs(jspecs, jshape, data_size=data)
    got = TSh.opt_pspecs(tspecs, tshape, data_size=data)
    assert sorted(got) == ["mu", "nu", "step"] and got["step"] == () == tuple(want["step"])
    assert port_flat(got) == jax_flat(want), arch
    assert port_flat(TA.zero1_specs(tspecs, tshape, data)) == \
        jax_flat(JA.zero1_specs(jspecs, jshape, data))


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_cache_pspecs_match_jax(arch):
    """Decode caches of ``decode_32k`` and, where the arch runs it,
    ``long_500k`` (slots over ``data``, no batch axis), at TP 16 and 4."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        if not TC.applicable(arch, name)[0]:
            continue
        jshape, tshape = JC.SHAPES[name], TC.SHAPES[name]
        jcache = JC.input_specs(jcfg, jshape)["cache"]
        tcache = TC.input_specs(tcfg, tshape)["cache"]
        for tp in (16, 4):
            want = jax_flat(JSh.cache_pspecs(jcache, jcfg, jshape, tp=tp))
            got = port_flat(TSh.cache_pspecs(tcache, tcfg, tshape, tp=tp))
            assert got == want, (arch, name, tp)
            assert got


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_batch_pspecs_match_jax(arch):
    for name in ("train_4k", "prefill_32k"):
        want = JSh.batch_pspecs(JC.get_config(arch), JC.SHAPES[name])
        got = TSh.batch_pspecs(TC.get_config(arch), TC.SHAPES[name])
        assert {k: tuple(s) for k, s in got.items()} == {k: tuple(s) for k, s in want.items()}
        assert all(isinstance(s, P) for s in got.values())
    with pytest.raises(ValueError):
        TSh.batch_pspecs(TC.get_config(arch), TC.SHAPES["decode_32k"])
    assert TSh.BATCH_AXES == JSh.BATCH_AXES


@pytest.mark.parametrize("axes,sizes", [(("data", "model"), (4, 1)),
                                        (("pod", "data", "model"), (2, 4, 1)),
                                        (("model",), (1,))])
def test_ef_residual_specs_match_jax(axes, sizes):
    jparams = {"a": jnp.zeros((3, 4)), "b": [jnp.zeros((5,)), {"c": jnp.zeros(())}]}
    tparams = {"a": torch.zeros((3, 4)), "b": [torch.zeros((5,)), {"c": torch.zeros(())}]}
    want = jax_flat(JCol.ef_residual_specs(jax.sharding.AbstractMesh(sizes, axes), jparams))
    got = port_flat(TCol.ef_residual_specs(make_mesh(sizes, axes), tparams))
    assert got == want
    assert len(got) == 3


SPECS = [JP(("pod", "data"), None), JP("pod"), None, JP(None, "model"), JP(),
         JP(("pod", "data", "model")), JP(("pod",), "data"), JP(None, ("data", "model"), None)]


@pytest.mark.parametrize("axes,sizes", [(("data", "model"), (2, 1)),
                                        (("pod", "data", "model"), (2, 2, 1)),
                                        (("data",), (4,))])
def test_sanitize_matches_jax(axes, sizes):
    jmesh, tmesh = jax.sharding.AbstractMesh(sizes, axes), make_mesh(sizes, axes)
    for spec in SPECS:
        tspec = None if spec is None else P(*spec)
        got = TS._sanitize(tspec, tmesh)
        assert isinstance(got, P) and got == tuple(JS._sanitize(spec, jmesh)), spec


def test_resolve_spec_matches_jax():
    """No mesh: ``None``, in both. Under a (data, model) mesh, axes the
    mesh does not name drop out and a 1-tuple becomes its name."""
    queries = [(("pod", "data"), None), ("model",), (None, "seq"), (("data", "model"),),
               ("pod", "data")]
    for q in queries:
        assert TH.resolve_spec(*q) is None and JH.resolve_spec(*q) is None
    with jax.set_mesh(jax_host_mesh(model=1)), TH.set_mesh(make_host_mesh(data=4)):
        for q in queries:
            got, want = TH.resolve_spec(*q), JH.resolve_spec(*q)
            assert isinstance(got, P) and got == tuple(want), q
        x = torch.ones(2)
        assert TH.maybe_shard(x, ("pod", "data")) is x
        assert TH.manual_axis_names() == () == JH.manual_axis_names()
    assert (TH.BATCH, TH.TP, TH.SEQ) == (JH.BATCH, JH.TP, JH.SEQ)


def test_spec_type_behaves_like_jax_partition_spec():
    s = P(("pod", "data"), None)
    assert s == (("pod", "data"), None) == tuple(JP(("pod", "data"), None))
    assert P(("data",)) == P("data") == ("data",) == tuple(JP(("data",)))
    assert len(s) == 2 and s[0] == ("pod", "data") and list(s) == [("pod", "data"), None]
    assert hash(P("data", None)) == hash(P(("data",), None)) and P() == ()
    assert P("data") != P("data", None) and P("data") != "data" and P(()) == (None,)
    with pytest.raises(AttributeError):
        s._parts = ()
    with pytest.raises(TypeError):
        P(3)
    assert leaves({"a": s, "b": [P()]}) == [s, P()]  # a spec is a tree leaf


def test_batch_axis_reads_raw_and_sanitized_specs():
    cfg = TC.get_config("qwen2-vl-7b")
    raw = TSh.batch_pspecs(cfg, TC.SHAPES["train_4k"])
    clean = TS._sanitized(make_host_mesh(data=2), raw)
    for specs in (raw, clean):
        assert {k: TSh.batch_axis(s) for k, s in specs.items()} == \
            {"embeds": 0, "positions": 1, "labels": 0}
    assert TSh.batch_axis(P(None, ("pod", "data"))) == 1
    with pytest.raises(ValueError):
        TSh.batch_axis(P(None, "model"))


# -- the JAX package's spec tests (tests/test_sharding_and_elastic.py,
# tests/test_steps_and_dryrun.py), ported --------------------------------


def test_param_specs_cover_every_leaf():
    for arch in TC.ARCHS:
        cfg = TC.get_config(arch)
        shapes = TT.model_init(torch.Generator(), cfg, device="meta")
        specs = TSh.param_pspecs(shapes, cfg, tp=16)
        ls, ss = leaves(shapes), leaves(specs)
        assert len(ls) == len(ss), arch
        for leaf, spec in zip(ls, ss):
            assert len(spec) <= len(leaf.shape), (arch, spec, leaf.shape)
            # any sharded dim must divide by tp
            for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 8):
                if ax == "model":
                    assert dim % 16 == 0, (arch, spec, leaf.shape)


def test_indivisible_dims_stay_replicated():
    cfg = TC.get_config("whisper-tiny")
    # whisper wq: (384, 384) — 384 % 16 == 0 -> sharded on the out dim
    assert tuple(TSh._param_spec(("mixer", "wq"), (384, 384), cfg, tp=16)) == (None, "model")
    # synthetic indivisible out dim -> fully replicated
    assert "model" not in tuple(TSh._param_spec(("mixer", "wq"), (384, 250), cfg, tp=16))
    # vocab table: 51865 % 16 != 0 -> replicated
    assert "model" not in tuple(TSh._param_spec(("embed", "table"), (51865, 384), cfg, tp=16))
    # llama3 vocab 128256 % 16 == 0 -> vocab-sharded
    assert tuple(TSh._param_spec(("embed", "table"), (128256, 4096), cfg, tp=16)) == \
        ("model", None)


def test_zero1_adds_data_axis():
    param_specs = {"w": P(None, "model")}
    shapes = {"w": torch.empty((64, 256), device="meta")}
    out = TA.zero1_specs(param_specs, shapes, data_size=16)
    assert out["mu"]["w"] == P("data", "model") and out["nu"]["w"] == P("data", "model")
    # indivisible first dim -> falls back to param spec
    out2 = TA.zero1_specs(param_specs, {"w": torch.empty((10, 256), device="meta")}, 16)
    assert out2["mu"]["w"] == P(None, "model")
    assert TA.zero1_leaf_spec(None, (32, 3), 16) == P("data", None)


def test_batch_and_cache_specs():
    cfg = TC.get_config("llama3-8b")
    b = TSh.batch_pspecs(cfg, TC.SHAPES["train_4k"])
    assert b["tokens"] == P(("pod", "data"), None) and b["labels"] == P(("pod", "data"), None)
    cache = TT.init_cache(cfg, 8, 128, device="meta")
    flat = leaves(TSh.cache_pspecs(cache, cfg, TC.SHAPES["decode_32k"], tp=16))
    assert flat, "no cache specs"
    # llama3: kv heads = 8 -> 8 % 16 != 0 -> heads replicated, batch over (pod, data)
    assert all(s == P(None, ("pod", "data"), None, None, None) for s in flat)


def test_sanitize_drops_missing_axes():
    mesh = make_host_mesh(data=1)  # axes: data, model
    assert TS._sanitize(P(("pod", "data"), None), mesh) == P("data", None)
    assert TS._sanitize(P("pod"), mesh) == P(None)
    assert TS._sanitize(None, mesh) == P()
    assert TS._sanitize(P(None, "model"), mesh) == P(None, "model")


def test_maybe_shard_no_mesh_noop():
    x = torch.ones((4, 4))
    assert TH.maybe_shard(x, ("pod", "data"), None) is x
    assert TH.resolve_spec("model") is None
