"""Tensor-parallel serving in the process form — prefill, greedy decode
at scalar and per-slot positions, a slot admission, and ``build_cell``'s
prefill and decode cells on a ``ProcessMesh`` — for the eight families
TP serves, against the port at TP = 1 and JAX's sharded prefill and
decode, on the CPU with gloo.

The smoke yi-6b, llama3-8b, h2o-danube-1.8b, starcoder2-3b,
deepseek-moe-16b, deepseek-v2-lite-16b, mamba2-2.7b and jamba-v0.1-52b
(its first 5 layers) run on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)``, with
two edge configs: an h2o-danube-1.8b window of 18 whose ring buffer
wraps during decode, and the absorbed MLA decode. At TP = 4 the dense
smoke archs (2 KV heads) hold every KV head on every rank.

What runs where, so that the file's wall time is that of its longest
part: a module fixture starts JAX's jitted ``make_prefill_step`` and
``make_serve_step`` for every config in one ``run_multidevice``
subprocess (the compiles in threads), a 4-rank spawn (``(1, 4)`` and
``(2, 2)``) and a 2-rank spawn (``(1, 2)``, and the refusals), all at
once, and builds the TP = 1 smoke cells meanwhile. The ranks run
``tests/_tp_serve_cases.py``; each one runs the port at TP = 1 on its
own DP rows first (``ref``), then the same traffic on its shards.

Tolerances, both sides in f32 compute (``_tp_cases.compute_dtype``):

* prefill logits within 1e-5 of the row's max |logit| of TP = 1's;
* decode logits within 1e-4: a decode step rounds its query and its
  softmax weights to the bf16 cache's dtype before the products (JAX's
  does too), so a TP rank's f32 value that lies a summation order away
  can round to the neighbouring bf16 value (measured: 5.4e-5 on the
  absorbed MLA decode at ``(2, 2)``, at most 1.3e-6 elsewhere);
* greedy tokens equal;
* a cache a prefill built (the prompts', the admission's): each bf16
  leaf (``k``/``v``, ``ckv``/``krope``, ``conv``) element by element at
  most one bf16 rounding step apart, plus 1e-5 of the leaf's scale —
  the cache stores a bf16 rounding of f32 values that TP sums in
  another order, so an element can land on the neighbouring bf16 value
  (measured: up to 0.95 of that bound, 1.1e-3 of the leaf's scale);
  the f32 SSM state within 1e-5 of its scale (measured 2.2e-6);
* a cache decode steps wrote: each leaf within 1e-2 of its scale, the
  SSM state within 2e-3 — each step rounds its query, its softmax
  weights and the rows it writes to bf16, and a step reads the rows
  the steps before it wrote, so the neighbouring-value roundings add
  up over the 4 steps (measured: 2.1e-3 and 2.6e-4 against TP = 1,
  4.0e-3 and 6.7e-4 against JAX);
* the cache leaves every rank holds whole (``ckv``/``krope``, K/V where
  the TP size does not divide the KV heads) bit-equal across the ranks
  of a TP group;
* the model group's payload of a prefill, a decode step and an
  admission equal to ``modeled_tp_serve_bytes``.

Each stage whose logits are compared starts from the TP = 1 run's cache
placed on the rank (``sharding.place_cache``), so its logits are one
function of the same inputs (``_tp_serve_cases.serve``).

Against JAX, with both packages' ``COMPUTE_DTYPE`` at f32: prefill
logits within 1e-4 of the row's max (measured 2.1e-6), the 4 greedy
tokens equal, the prefill's and the 4 steps' caches by the rules above
(``conv`` gathered into JAX's layout by ``gather_cache``). JAX's scalar-position
GQA decode cannot write its bf16 cache in f32 compute (ROADMAP §3), so
its steps run at per-slot positions equal across the rows, the same
function. The dense and SSM archs are held on ``(2, 2)``; the MoE archs
(deepseek-moe-16b, deepseek-v2-lite-16b, jamba) on ``(1, 4)``: a port
DP rank's MoE capacity comes from its own tokens, as in JAX's
``shard_map`` train step, while JAX's GSPMD prefill cell takes the
global batch's (on these prompts the smoke deepseek-moe-16b's logits
differ by 0.31 of their scale between the two), so on a mesh with
``data`` > 1 the two are different functions wherever the capacity
drops tokens. ``build_cell`` refuses those archs' cells there for that
reason (ROADMAP 9c, entry 10); the step builders serve each DP rank's
rows as a replica would.
"""

from __future__ import annotations

import math
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _tp_serve_cases as sc  # noqa: E402
from _tp_cases import compute_dtype  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.launch import dist as tdist  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import hints  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.spec import keep_axes  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
PREFILL_TOL, DECODE_TOL, JAX_TOL = 1e-5, 1e-4, 1e-4
DECODED_TOL, DECODED_SSM_TOL = 1e-2, 2e-3
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to the larger value
JAX_NAMES = sc.ARCHS + ("h2o_window_18",)
JAX_MESH = {n: "1x4" if n in sc.MOE_ARCHS else "2x2" for n in JAX_NAMES}

_JAX_SERVE = """
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from jax.sharding import NamedSharding
from repro import configs as C
from repro.launch.steps import _named, make_prefill_step, make_serve_step
from repro.models import layers as L
from repro.models import transformer as T
from repro.parallel import sharding as shd

L.COMPUTE_DTYPE = jnp.float32
d = np.load({inputs!r})
B, S, STEPS, MAX_SEQ = {B}, {S}, {STEPS}, {MAX_SEQ}


def run(job):
    name, base, changes, shape = job
    cfg = dataclasses.replace(C.get_smoke_config(base), **changes)
    like = jax.eval_shape(lambda: T.model_init(jax.random.PRNGKey(0), cfg))
    flat, treedef = jax.tree.flatten(like)
    params = jax.tree.unflatten(treedef, [d[f"{{name}}/p{{i}}"] for i in range(len(flat))])
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tp = shape[1]

    # the cells' shardings (build_cell's own _named: axes the mesh lacks dropped)
    psh = _named(mesh, shd.param_pspecs(like, cfg, tp=tp))
    cache_like = jax.eval_shape(lambda: T.init_cache(cfg, B, MAX_SEQ))
    csh = _named(mesh, shd.cache_pspecs(cache_like, cfg, C.SHAPES["decode_32k"], tp=tp))
    rows = NamedSharding(mesh, P("data"))
    prefill = jax.jit(make_prefill_step(cfg, MAX_SEQ),
                      in_shardings=(psh, {{"tokens": NamedSharding(mesh, P("data", None))}}),
                      out_shardings=(NamedSharding(mesh, P("data", None)), csh))
    serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, rows, rows, csh),
                    out_shardings=(rows, csh))
    out = {{}}
    with jax.set_mesh(mesh):
        p = jax.tree.map(jax.device_put, params, psh)
        logits, cache = prefill(p, {{"tokens": d[f"{{name}}/tokens"]}})
        out[f"{{name}}/logits"] = np.asarray(logits)
        for i, x in enumerate(jax.tree.leaves(cache)):
            out[f"{{name}}/prefill_cache{{i}}"] = np.asarray(x, np.float32)
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        for s in range(STEPS):
            tok, cache = serve(p, tok, np.full((B,), S + s, np.int32), cache)
            out[f"{{name}}/tokens{{s}}"] = np.asarray(tok)
        for i, x in enumerate(jax.tree.leaves(cache)):
            out[f"{{name}}/decode_cache{{i}}"] = np.asarray(x, np.float32)
    return out


jobs = {jobs!r}
out = {{}}
with ThreadPoolExecutor(len(jobs)) as ex:
    for o in ex.map(run, jobs):
        out.update(o)
np.savez({out!r}, **out)
"""


def _smoke_shapes(monkeypatch):
    for name, (kind, seq, batch) in sc.SMOKE_SHAPES.items():
        monkeypatch.setitem(C.SHAPES, name, Shape(name, kind, seq, batch))


def _tp1_cells() -> dict:
    """The smoke prefill and decode cells of ``SMOKE_CELL_ARCHS`` at TP = 1
    (a one-rank ``VirtualMesh``), run in f32 compute on each block of
    rows a DP rank of ``(1, ·)`` or ``(2, 2)`` holds, keyed ``(dp,
    block)``; a MoE arch's only on ``(1, ·)``, since ``build_cell``
    refuses its cells on ``(2, 2)``."""
    out = {}
    for arch in sc.SMOKE_CELL_ARCHS:
        for shape in sc.SMOKE_SHAPES:
            cell = build_cell(arch, shape, make_host_mesh(), smoke=True, device="cpu")
            batch = sc.SMOKE_SHAPES[shape][2]
            for dp in (1,) if arch in sc.MOE_ARCHS else (1, 2):
                n = batch // dp
                for i in range(dp):
                    rows = slice(i * n, (i + 1) * n)
                    if shape == "prefill_smoke":
                        args = (cell.args[0], {k: v[rows] for k, v in cell.args[1].items()})
                    else:
                        params, tokens, pos, _ = cell.args
                        args = (params, tokens[rows], pos,
                                T.init_cache(cell.cfg, n, cell.shape.seq_len, device="cpu"))
                    with torch.no_grad(), compute_dtype(torch.float32):
                        first, cache = cell.step_fn(*args)
                    out[f"{arch}/{shape}/{dp}/{i}"] = {
                        "out": first.float().numpy(),
                        "cache": [x.float().numpy() for x in leaves(cache)]}
    return out


@pytest.fixture(scope="module")
def runs(run_multidevice, tmp_path_factory):
    """Everything that runs outside this process, started at once: JAX's
    sharded prefill and decode, and the two spawns; meanwhile the TP = 1
    smoke cells. Returns their results."""
    root = tmp_path_factory.mktemp("tp_serve")
    params = {name: sc.init_params(sc.config(name)) for name in sc.NAMES}
    inputs, jobs = {}, []
    for name in JAX_NAMES:
        inputs.update({f"{name}/p{i}": x for i, x in enumerate(leaves(params[name]))})
        inputs[f"{name}/tokens"] = sc.prompts(sc.config(name).vocab_size)
        base, changes = sc.EDGES.get(name, (name, {}))
        if name in sc.LAYERS:
            changes = dict(changes, num_layers=sc.LAYERS[name])
        jobs.append((name, base, changes, MESHES[JAX_MESH[name]]))
    np.savez(root / "in.npz", **inputs)
    code = _JAX_SERVE.format(inputs=str(root / "in.npz"), out=str(root / "out.npz"), jobs=jobs,
                             B=sc.B, S=sc.S, STEPS=sc.STEPS, MAX_SEQ=sc.MAX_SEQ)
    mp = pytest.MonkeyPatch()
    _smoke_shapes(mp)
    try:
        with ThreadPoolExecutor(3) as ex:
            jax_run = ex.submit(run_multidevice, code, devices=4, timeout=900)
            world4 = ex.submit(tdist.spawn, sc.world4_rank, 4, device="cpu", timeout_s=600,
                               args=(params,))
            world2 = ex.submit(tdist.spawn, sc.world2_rank, 2, device="cpu", timeout_s=600,
                               args=(params,))
            tp1_cells = _tp1_cells()
            jax_run.result()
            return types.SimpleNamespace(world4=world4.result(), world2=world2.result(),
                                         jax=dict(np.load(root / "out.npz")), tp1_cells=tp1_cells)
    finally:
        mp.undo()


def _ranks(runs, mesh: str) -> list[dict]:
    ranks = runs.world2 if mesh == "1x2" else runs.world4
    return [r["cases"][mesh] for r in ranks]


def _max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _rows_rel(a: np.ndarray, b: np.ndarray) -> float:
    """The worst row's max |a - b| over that row's max |b|."""
    return float((np.abs(a - b).max(-1) / np.maximum(np.abs(b).max(-1), 1e-30)).max())


def _caches_close(keys, got, want, decoded: bool) -> None:
    """A cache a prefill built (``decoded=False``): each bf16 leaf element
    by element at most one bf16 rounding step apart (plus 1e-5 of the
    leaf's scale), the f32 SSM state within 1e-5 of its scale. One that
    decode steps wrote: each leaf within ``DECODED_TOL`` of its scale,
    the SSM state within ``DECODED_SSM_TOL``."""
    assert len(got) == len(want) == len(keys)
    for key, a, b in zip(keys, got, want):
        assert a.shape == b.shape, (key, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-30)
        if decoded:
            assert _max_rel(a, b) < (DECODED_SSM_TOL if key == "ssm" else DECODED_TOL), key
        elif key == "ssm":
            assert _max_rel(a, b) < PREFILL_TOL, key
        else:
            bound = BF16_STEP * np.maximum(np.abs(a), np.abs(b)) + 1e-5 * scale
            assert (np.abs(a - b) <= bound).all(), (key, float((np.abs(a - b) / bound).max()))


# ---------------------------------------------------------------------------
# Against the port at TP = 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sc.NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logits_and_tokens_match_tp1(runs, mesh, name):
    """Prefill logits within 1e-5 of the row's max of TP = 1's, the
    decode steps' logits (scalar and per-slot positions) within 1e-4,
    the greedy tokens and the admission's first token equal; the logits
    (whole on every rank: the vocab-split head's blocks gathered) of the
    ranks of a TP group bit-equal."""
    for r in _ranks(runs, mesh):
        got, want = r["serve"][name], r["serve"][name]["ref"]
        assert got["prefill_logits"].shape == (sc.B // MESHES[mesh][0],
                                               sc.config(name).vocab_size)
        assert _rows_rel(got["prefill_logits"], want["prefill_logits"]) < PREFILL_TOL
        for key in ("decode_logits", "slot_logits"):
            assert _rows_rel(got[key], want[key]) < DECODE_TOL, key
        for key in ("tokens", "slot_tokens"):
            assert all(np.array_equal(a, b) for a, b in zip(got[key], want[key])), key
        assert got["slot_token"] == want["slot_token"]
    _tp_groups_agree(runs, mesh, name, ("prefill_logits", "decode_logits", "slot_logits"))


def _tp_groups_agree(runs, mesh, name, keys) -> None:
    groups: dict = {}
    for r in _ranks(runs, mesh):
        groups.setdefault(r["serve"][name]["dp_index"], []).append(r["serve"][name])
    for members in groups.values():
        assert len(members) == MESHES[mesh][1]
        for other in members[1:]:
            for key in keys:
                assert np.array_equal(other[key], members[0][key]), key


@pytest.mark.parametrize("name", sc.NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_caches_match_tp1(runs, mesh, name):
    """The caches after the prefill, the scalar steps, the admission, the
    per-slot steps and the last decode step, gathered (``gather_cache``),
    against TP = 1's: a prefill's within one bf16 rounding step a bf16
    element (its SSM state within 1e-5), the decoded ones within 1e-2 of
    each leaf's scale (the SSM state 2e-3)."""
    for r in _ranks(runs, mesh):
        got, want = r["serve"][name], r["serve"][name]["ref"]
        for key in ("prefill_cache", "decode_cache", "slot_cache", "slot_steps_cache",
                    "final_cache"):
            _caches_close(got["cache_keys"], got[key], want[key],
                          decoded=key not in ("prefill_cache", "slot_cache"))


@pytest.mark.parametrize("name", sc.NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_cache_leaves_are_bit_equal_across_tp_ranks(runs, mesh, name):
    """Every cache leaf a rank holds whole — ``ckv``/``krope``, and K/V at
    TP = 4 where the smoke archs have 2 KV heads — holds the same bits
    on every rank of a TP group after the whole traffic; the split
    leaves (K/V by heads, ``ssm`` by heads, ``conv`` in the rank's
    layout) differ."""
    groups: dict = {}
    for r in _ranks(runs, mesh):
        groups.setdefault(r["serve"][name]["dp_index"], []).append(r["serve"][name])
    cfg = sc.config(name)
    tp = MESHES[mesh][1]
    for members in groups.values():
        first = members[0]
        for key, rep in zip(first["cache_keys"], first["cache_replicated"]):
            if key in ("ckv", "krope"):
                assert rep
            if key in ("k", "v"):
                assert rep == (cfg.num_kv_heads % tp != 0)
        for other in members[1:]:
            for rep, a, b in zip(first["cache_replicated"], first["local_cache"],
                                 other["local_cache"]):
                assert np.array_equal(a, b) == rep or (not rep and a.shape != b.shape)


@pytest.mark.parametrize("name", sc.NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_payload_bytes_match_their_model(runs, mesh, name):
    """The payload bytes a rank hands the model group's collectives in a
    prefill, a decode step and a slot admission equal
    ``modeled_tp_serve_bytes``: the mixers' and FFNs' all-reduces, the
    K/V gather (of the new row in decode) where a rank holds every KV
    head, Mamba-2's sum of squares, the embedding's all-reduce and the
    logits' gather."""
    for r in _ranks(runs, mesh):
        got = r["serve"][name]
        for key in ("prefill", "decode", "slot"):
            assert got[f"{key}_bytes"] == got["modeled"][key], key
            assert got[f"{key}_bytes"]["fwd"] > 0 and got[f"{key}_bytes"]["bwd"] == 0


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", JAX_NAMES)
def test_prefill_and_decode_match_jax_sharded(runs, name):
    """The port's TP serving against JAX's jitted ``make_prefill_step``
    and ``make_serve_step`` with ``NamedSharding``s from
    ``param_pspecs``/``cache_pspecs`` on the same ``(data, model)`` mesh
    (``(2, 2)``; the MoE archs ``(1, 4)``, module docstring), f32
    compute: prefill logits within 1e-4 of the row's max, 4 greedy
    tokens equal, the prefill's and the steps' caches, ``conv`` in JAX's
    layout, by the rules of the module docstring."""
    mesh = JAX_MESH[name]
    dp = MESHES[mesh][0]
    n = sc.B // dp
    j = runs.jax
    nleaves = len(_ranks(runs, mesh)[0]["serve"][name]["cache_keys"])
    for r in _ranks(runs, mesh):
        got = r["serve"][name]
        rows = slice(got["dp_index"] * n, (got["dp_index"] + 1) * n)
        assert _rows_rel(got["prefill_logits"], j[f"{name}/logits"][rows]) < JAX_TOL
        for s in range(sc.STEPS):
            assert np.array_equal(got["tokens"][s], j[f"{name}/tokens{s}"][rows]), s
        for key in ("prefill_cache", "decode_cache"):
            want = [j[f"{name}/{key}{i}"][:, rows] for i in range(nleaves)]
            _caches_close(got["cache_keys"], got[key], want, decoded=key == "decode_cache")


def test_moe_dp_capacity_differs_from_the_global_batch():
    """Why the MoE archs meet JAX on ``(1, 4)``, and why ``build_cell``
    refuses their cells with ``data`` > 1 (9c entry 10): the port at
    TP = 1 on each DP rank's rows (its capacity from its own tokens) is
    not the prefill of the whole batch for the smoke deepseek-moe-16b,
    so a ``data`` > 1 mesh would hold two different functions against
    each other."""
    cfg = sc.config("deepseek-moe-16b")
    from repro_torch.models.convert import params_from_numpy

    p = params_from_numpy(sc.init_params(cfg), "cpu")
    rows = torch.from_numpy(sc.prompts(cfg.vocab_size))
    with torch.no_grad(), compute_dtype(torch.float32):
        whole = T.prefill(p, cfg, {"tokens": rows}, sc.MAX_SEQ)[0]
        halves = torch.cat([T.prefill(p, cfg, {"tokens": rows[i * 2:(i + 1) * 2]},
                                      sc.MAX_SEQ)[0] for i in range(2)])
    assert _max_rel(halves.numpy(), whole.numpy()) > 0.1


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _block_shape(shape, spec, mesh_shape) -> tuple:
    return tuple(d // math.prod(mesh_shape.get(a, 1) for a in
                                ((e,) if isinstance(e, str) else (e or ())))
                 for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


@pytest.mark.parametrize("arch", sc.CELL_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_meta_cells_hold_the_blocks_their_specs_give(runs, mesh, arch):
    """``build_cell(arch, shape, ProcessMesh)`` at ``prefill_32k`` and
    ``decode_32k`` on the meta device: each arg is the rank's block of
    the logical one by the cell's specs (params by ``param_pspecs``, the
    batch rows and decode tokens over ``data``, the cache by
    ``cache_pspecs``), but for the Mamba-2 ``conv`` window, whose last
    dim is the rank's ``x`` block beside all of B/C; the specs are
    JAX's (``param_pspecs``/``cache_pspecs``, equal to JAX's by
    ``tests/test_torch_specs.py``). A MoE arch's cells on ``(2, 2)``
    raise instead, naming 9c entry 10 (:func:`_assert_moe_refused`)."""
    dp, tp = MESHES[mesh]
    if dp > 1 and arch in sc.MOE_ARCHS:
        for r in _ranks(runs, mesh):
            for shape_name in sc.CELL_SHAPES:
                _assert_moe_refused(r["meta_cells"][f"{arch}/{shape_name}"]["refused"])
        return
    mesh_shape = {"data": dp, "model": tp}
    cfg = C.get_config(arch)
    params = T.model_init(torch.Generator(), cfg, "meta")
    pspecs = shd.param_pspecs(params, cfg, tp=tp)
    want_params = [_block_shape(x.shape, s, mesh_shape)
                   for x, s in zip(leaves(params), leaves(pspecs))]
    for shape_name in sc.CELL_SHAPES:
        shape = C.SHAPES[shape_name]
        specs = C.input_specs(cfg, shape)
        if shape.kind == "prefill":
            cache = T.init_cache(cfg, shape.global_batch, specs["max_seq"], "meta")
            other = [[_block_shape(x.shape, s, mesh_shape) for x, s in zip(
                leaves(specs["batch"]), leaves(shd.batch_pspecs(cfg, shape)))]]
        else:
            cache = specs["cache"]
            other = [[(shape.global_batch // dp,)], [()]]
        cspecs = shd.cache_pspecs(cache, cfg, shape, tp=tp)
        want_cache = []
        for (path, x), s in zip(paths(cache), leaves(cspecs)):
            block = _block_shape(x.shape, s, mesh_shape)
            if path[-1] == "conv" and cfg.d_inner % tp == 0:
                G, N = cfg.ssm_ngroups, cfg.ssm_state
                block = block[:-1] + (cfg.d_inner // tp + 2 * G * N,)
            want_cache.append(block)
        # the specs as the cell states them: axes the mesh lacks ("pod") dropped
        cspecs_str = [str(keep_axes(s, ("data", "model"))) for s in leaves(cspecs)]
        for r in _ranks(runs, mesh):
            got = r["meta_cells"][f"{arch}/{shape_name}"]
            assert got["args"][0] == want_params
            assert got["in_specs"][:len(want_params)] == [str(s) for s in leaves(pspecs)]
            if shape.kind == "prefill":
                assert got["args"][1:] == other
                assert got["out_specs"][1:] == cspecs_str
            else:
                assert got["args"][1:3] == other and got["args"][3] == want_cache
                assert got["in_specs"][-len(want_cache):] == cspecs_str


@pytest.mark.parametrize("mesh", list(MESHES))
def test_place_and_gather_cache_round_trip(runs, mesh):
    """``gather_cache`` of ``place_cache`` gives back a logical cache of the
    global batch bit for bit on every rank (its rows over ``data``, the
    ``conv`` window from the rank's layout into JAX's), and the placed
    blocks have the shapes of the cache the rank's own prefill and
    decode built."""
    for r in _ranks(runs, mesh):
        for name in sc.NAMES:
            got = r["serve"][name]
            assert got["round_trip_equal"], name
            assert got["placed_shapes"] == [a.shape for a in got["local_cache"]], name


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sc.SMOKE_CELL_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_smoke_cells_match_tp1_cells(runs, mesh, arch):
    """The smoke prefill and decode cells built on the ``ProcessMesh`` and
    run (``cell.step_fn(*cell.args)``, f32 compute) against the TP = 1
    cells from the same seeds: prefill logits of the rank's rows within
    1e-5 of the row's max, decode tokens equal, the gathered caches by
    the rules of the module docstring. A MoE arch's cells on ``(2, 2)``
    raise instead, naming 9c entry 10 (:func:`_assert_moe_refused`)."""
    dp = MESHES[mesh][0]
    if dp > 1 and arch in sc.MOE_ARCHS:
        for r in _ranks(runs, mesh):
            for shape in sc.SMOKE_SHAPES:
                _assert_moe_refused(r["smoke_cells"][f"{arch}/{shape}"]["refused"])
        return
    cfg = C.get_smoke_config(arch)
    with hints.set_mesh(None):
        keys = [p[-1] for p, _ in paths(T.init_cache(cfg, 1, 1, "meta"))]
    for r in _ranks(runs, mesh):
        for shape in sc.SMOKE_SHAPES:
            got = r["smoke_cells"][f"{arch}/{shape}"]
            want = runs.tp1_cells[f"{arch}/{shape}/{dp}/{_dp_index(r)}"]
            if shape == "prefill_smoke":
                assert _rows_rel(got["out"], want["out"]) < PREFILL_TOL
            else:
                assert np.array_equal(got["out"], want["out"])
            _caches_close(keys, got["cache"], want["cache"], decoded=shape == "decode_smoke")


def _dp_index(r) -> int:
    return next(iter(r["serve"].values()))["dp_index"]


def _assert_moe_refused(msg) -> None:
    assert msg is not None and "9c" in msg and "entry 10" in msg, msg
    assert "global batch" in msg, msg


@pytest.mark.parametrize("name", list(sc.CELL_REFUSALS))
def test_unported_cells_raise_naming_their_entry(runs, name):
    """On a ``ProcessMesh`` with a live ``model`` axis, a train cell of
    an arch TP does not cover (qwen2-vl-7b: M-RoPE, 9c entry 2; train
    cells are built since ZeRO-1's placement, entry 5, was ported),
    ``long_500k`` (its slots split over ``data``, entry 9), the
    qwen2-vl-7b and whisper-tiny serve cells (entries 2 and 3), and on
    ``(2, 2)`` a flat-dispatch MoE arch's serve cell (its capacity from
    the global batch, entry 10) raise ``NotImplementedError`` naming
    ROADMAP item 9c and the entry."""
    entry, mesh = sc.CELL_REFUSALS[name][2:]
    words = {"train": "M-RoPE", "long_500k": "slots", "qwen2-vl-7b": "M-RoPE",
             "whisper-tiny": "encoder-decoder", "moe_over_data": "global batch"}
    for r in runs.world2 if mesh == "1x2" else runs.world4:
        msg = r["refusals"][name]
        assert msg is not None and "9c" in msg and f"entry {entry}" in msg, msg
        assert words[name] in msg
