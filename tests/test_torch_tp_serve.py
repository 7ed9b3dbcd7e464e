"""Tensor-parallel serving in the process form — prefill, greedy decode
at scalar and per-slot positions, a slot admission, and ``build_cell``'s
prefill and decode cells on a ``ProcessMesh`` — for all ten
architectures, against the port at TP = 1 and JAX's sharded prefill and
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
(``conv`` gathered into JAX's layout by ``gather_cache``). JAX's
scalar-position GQA decode cannot write its bf16 cache in f32 compute
(ROADMAP §3), so its steps run at per-slot positions equal across the
rows, the same function; qwen2-vl's M-RoPE decode takes only a scalar
position, so one step of it is compared in bf16 compute (within 5e-2).
Every arch is held on ``(2, 2)``: a flat-dispatch MoE over a live
``data`` axis takes the global batch's capacity and positions, as
JAX's GSPMD cell does (the ranks exchange their per-expert counts), so
its TP = 1 reference is the whole batch's run cut to a rank's rows
(``_tp_serve_cases._cut``), and deepseek-moe-16b runs on ``(2, 1)`` too.
qwen2-vl, whisper and whisper with 6 heads under ``opt-seq``
(``_tp_serve_cases.FIXED``) serve on ``(1, 4)`` and ``(2, 2)`` against
TP = 1 and JAX.
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
from repro_torch.launch.steps import VARIANTS, build_cell  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import hints  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.spec import keep_axes  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SHAPES = {**MESHES, "2x1": (2, 1)}  # the (data=2, model=1) mesh serves DP_NAMES alone
PREFILL_TOL, DECODE_TOL, JAX_TOL = 1e-5, 1e-4, 1e-4
DECODED_TOL, DECODED_SSM_TOL = 1e-2, 2e-3
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to the larger value
JAX_NAMES = sc.ARCHS + ("h2o_window_18",)
JAX_MESH = {n: "2x2" for n in JAX_NAMES}
# the MoE arch over data alone, against JAX's cell of the global batch
JAX_DP = {"deepseek-moe-16b/2x1": ("deepseek-moe-16b", "2x1")}
# qwen2-vl and whisper on (2, 2) and (1, 4), the opt-seq edge on (1, 4)
JAX_FIXED = {f"{n}/{m}": (n, m) for n in ("qwen2-vl-7b", "whisper-tiny") for m in ("2x2", "1x4")}
JAX_FIXED["whisper_6_heads_opt_seq/1x4"] = ("whisper_6_heads_opt_seq", "1x4")
FIXED_BF16_TOL = 5e-2  # bf16 decode logits against JAX's, of the row's max

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


def batch_sharding(mesh, batch):
    return {{k: NamedSharding(mesh, P(None, "data", None) if k == "positions" else
                              P("data", *([None] * (v.ndim - 1)))) for k, v in batch.items()}}


def run(job):
    name, key, base, changes, shape, fixed = job
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
    batch = {{k: d[f"{{name}}/{{k}}"] for k in ("tokens", "embeds", "positions", "enc_frames")
              if f"{{name}}/{{k}}" in d}}
    prefill = jax.jit(make_prefill_step(cfg, MAX_SEQ),
                      in_shardings=(psh, batch_sharding(mesh, batch)),
                      out_shardings=(NamedSharding(mesh, P("data", None)), csh))
    serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, rows, rows, csh),
                    out_shardings=(rows, csh))
    out = {{}}
    with jax.set_mesh(mesh):
        p = jax.tree.map(jax.device_put, params, psh)
        logits, cache = prefill(p, batch)
        out[f"{{key}}/logits"] = np.asarray(logits)
        for i, x in enumerate(jax.tree.leaves(cache)):
            out[f"{{key}}/prefill_cache{{i}}"] = np.asarray(x, np.float32)
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        if cfg.family == "vlm":
            # a scalar M-RoPE decode writes its bf16 cache only in bf16
            # compute: one step from the prefill's cache, after the threads
            LATER.append((key, cfg, mesh, psh, rows, csh, p, tok, cache))
            return out
        for s in range(STEPS):
            tok, cache = serve(p, tok, np.full((B,), S + s, np.int32), cache)
            out[f"{{key}}/tokens{{s}}"] = np.asarray(tok)
        for i, x in enumerate(jax.tree.leaves(cache)):
            out[f"{{key}}/decode_cache{{i}}"] = np.asarray(x, np.float32)
    return out


LATER = []
jobs = {jobs!r}
out = {{}}
with ThreadPoolExecutor(len(jobs)) as ex:
    for o in ex.map(run, jobs):
        out.update(o)
# the long-context decode: decode_step on the whole seeded cache, one row
# at a per-slot position (JAX's scalar GQA decode writes its bf16 cache
# only in bf16 compute)
for name, base, changes, positions in {long_jobs!r}:
    cfg = dataclasses.replace(C.get_smoke_config(base), **changes)
    like = jax.eval_shape(lambda: T.model_init(jax.random.PRNGKey(0), cfg))
    flat, treedef = jax.tree.flatten(like)
    params = jax.tree.unflatten(treedef, [d[f"{{name}}/p{{i}}"] for i in range(len(flat))])
    cflat, ctree = jax.tree.flatten(jax.eval_shape(lambda: T.init_cache(cfg, 1, {LONG_SLOTS})))
    cache = jax.tree.unflatten(ctree, [jnp.asarray(d[f"long/{{name}}/c{{i}}"], x.dtype)
                                       for i, x in enumerate(cflat)])
    step = jax.jit(lambda p, pos, c, cfg=cfg: T.decode_step(p, cfg, jnp.array([7], jnp.int32),
                                                            pos, c))
    for pos in positions:
        logits, new = step(params, jnp.array([pos], jnp.int32), cache)
        out[f"long/{{name}}/{{pos}}/logits"] = np.asarray(logits)
        for i, x in enumerate(jax.tree.leaves(new)):
            out[f"long/{{name}}/{{pos}}/cache{{i}}"] = np.asarray(x, np.float32)
    logits, new = jax.jit(lambda p, b, cfg=cfg: T.prefill(p, cfg, b, {LONG_SLOTS}))(
        params, {{"tokens": jnp.asarray(d[f"long/{{name}}/prompt"])}})
    out[f"long/{{name}}/prefill/logits"] = np.asarray(logits)
    for i, x in enumerate(jax.tree.leaves(new)):
        out[f"long/{{name}}/prefill/cache{{i}}"] = np.asarray(x, np.float32)
L.COMPUTE_DTYPE = jnp.bfloat16  # traced after every thread has finished
for key, cfg, mesh, psh, rows, csh, p, tok, cache in LATER:
    with jax.set_mesh(mesh):
        step = jax.jit(lambda p, t, c, cfg=cfg: T.decode_step(p, cfg, t, jnp.int32(S), c)[0],
                       in_shardings=(psh, rows, csh))
        out[f"{{key}}/bf16_decode_logits"] = np.asarray(step(p, tok, cache), np.float32)
np.savez({out!r}, **out)
"""


def _smoke_shapes(monkeypatch):
    for name, (kind, seq, batch) in sc.SMOKE_SHAPES.items():
        monkeypatch.setitem(C.SHAPES, name, Shape(name, kind, seq, batch))


def _tp1_cells() -> dict:
    """The smoke prefill and decode cells of ``SMOKE_CELL_ARCHS`` at TP = 1
    (a one-rank ``VirtualMesh``), run in f32 compute on each block of
    rows a DP rank of ``(1, ·)`` or ``(2, 2)`` holds, keyed ``(dp,
    block)``; a MoE arch's on the whole batch only (``(1, ·)``): on
    ``(2, 2)`` its cells take the global batch's capacity, so a rank's
    rows are cut from that run."""
    out = {}
    for arch in sc.SMOKE_CELL_ARCHS:
        for shape in sc.SMOKE_SHAPES:
            cell = build_cell(arch, shape, make_host_mesh(), smoke=True, device="cpu")
            batch = sc.SMOKE_SHAPES[shape][2]
            # a MoE arch's cells over data and the one replicated sequence
            # of long_smoke are held against the whole batch's
            for dp in (1,) if arch in sc.MOE_ARCHS or batch == 1 else (1, 2):
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
    params = {name: sc.init_params(sc.config(name))
              for name in sc.NAMES + sc.FIXED + tuple(sc.LONG_EDGES)}
    caches = {name: sc.long_cache(name) for name in sc.LONG_NAMES}
    inputs, jobs = {}, []
    long_jobs = []
    for name in sc.LONG_NAMES:
        inputs.update({f"long/{name}/c{i}": x for i, x in enumerate(caches[name])})
        inputs[f"long/{name}/prompt"] = sc.long_prompt(sc.config(name).vocab_size)
        base, changes = sc.LONG_EDGES.get(name, (name, {}))
        if name in sc.LAYERS:
            changes = dict(changes, num_layers=sc.LAYERS[name])
        long_jobs.append((name, base, changes, sc.long_positions(name)))
    jax_jobs = [(n, n, JAX_MESH[n]) for n in JAX_NAMES]
    jax_jobs += [(k, n, m) for k, (n, m) in {**JAX_DP, **JAX_FIXED}.items()]
    for key, name, mesh in jax_jobs:
        if f"{name}/p0" not in inputs:
            inputs.update({f"{name}/p{i}": x for i, x in enumerate(leaves(params[name]))})
            if name in sc.FIXED:
                inputs.update({f"{name}/{k}": v for k, v in
                               sc.fixed_batch(sc.config(name)).items()})
            else:
                inputs[f"{name}/tokens"] = sc.prompts(sc.config(name).vocab_size)
        if name in sc.FIXED_EDGES:
            base, variant, changes = sc.FIXED_EDGES[name]
            changes = {**VARIANTS[variant], **changes}
        else:
            base, changes = sc.EDGES.get(name, (name, {}))
        if name in sc.LAYERS:
            changes = dict(changes, num_layers=sc.LAYERS[name])
        jobs.append((name, key, base, changes, SHAPES[mesh], name in sc.FIXED))
    for name in sc.LONG_NAMES:  # the params of the long configs no job above carries
        if f"{name}/p0" not in inputs:
            inputs.update({f"{name}/p{i}": x for i, x in enumerate(leaves(params[name]))})
    np.savez(root / "in.npz", **inputs)
    code = _JAX_SERVE.format(inputs=str(root / "in.npz"), out=str(root / "out.npz"), jobs=jobs,
                             B=sc.B, S=sc.S, STEPS=sc.STEPS, MAX_SEQ=sc.MAX_SEQ,
                             long_jobs=long_jobs, LONG_SLOTS=sc.LONG_SLOTS)
    mp = pytest.MonkeyPatch()
    _smoke_shapes(mp)
    try:
        with ThreadPoolExecutor(3) as ex:
            jax_run = ex.submit(run_multidevice, code, devices=4, timeout=900)
            world4 = ex.submit(tdist.spawn, sc.world4_rank, 4, device="cpu", timeout_s=600,
                               args=(params, caches))
            world2 = ex.submit(tdist.spawn, sc.world2_rank, 2, device="cpu", timeout_s=600,
                               args=(params, caches))
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
        assert np.array_equal(got["slot_token"], want["slot_token"])
    _tp_groups_agree(runs, mesh, name, ("prefill_logits", "decode_logits", "slot_logits"))


def _tp_groups_agree(runs, mesh, name, keys, kind: str = "serve") -> None:
    groups: dict = {}
    for r in _ranks(runs, mesh):
        groups.setdefault(r[kind][name]["dp_index"], []).append(r[kind][name])
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
    (``(2, 2)``; a MoE's capacity the global batch's there), f32
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


def test_moe_dp_capacity_differs_from_the_global_batch(runs):
    """Why a DP rank must not take its MoE capacity from its own tokens
    where JAX's cell sees the global batch (ROADMAP 9c entry 10, ported):
    the port at TP = 1 on each DP rank's rows alone is not the prefill of
    the whole batch for the smoke deepseek-moe-16b (> 0.1 of the logit
    scale apart), while the port's prefill on two DP ranks of a
    ``(data=2, model=1)`` mesh, the ranks exchanging their per-expert
    counts, is the whole batch's rows within ``PREFILL_TOL``."""
    cfg = sc.config("deepseek-moe-16b")
    from repro_torch.models.convert import params_from_numpy

    p = params_from_numpy(sc.init_params(cfg), "cpu")
    rows = torch.from_numpy(sc.prompts(cfg.vocab_size))
    with torch.no_grad(), compute_dtype(torch.float32):
        whole = T.prefill(p, cfg, {"tokens": rows}, sc.MAX_SEQ)[0]
        halves = torch.cat([T.prefill(p, cfg, {"tokens": rows[i * 2:(i + 1) * 2]},
                                      sc.MAX_SEQ)[0] for i in range(2)])
    assert _max_rel(halves.numpy(), whole.numpy()) > 0.1
    got = np.concatenate([r["cases"]["2x1"]["serve"]["deepseek-moe-16b"]["prefill_logits"]
                          for r in runs.world2])
    assert _rows_rel(got, whole.numpy()) < PREFILL_TOL


@pytest.mark.parametrize("name", sc.DP_NAMES)
def test_moe_over_data_matches_the_global_batch(runs, name):
    """A flat-dispatch MoE arch served on ``(data=2, model=1)``: each
    rank's prefill, decode and admission against the TP = 1 run of the
    whole batch with both ranks' admissions, each prefilled alone (JAX's
    slot prefill is a function of its one prompt), cut to its rows
    (logits, tokens, caches by the module docstring's rules), and against
    JAX's GSPMD prefill and decode cell of the global batch on the same
    mesh; the exchange of the per-expert counts is the payload
    ``modeled_tp_serve_bytes(dp=2)`` gives (2·E f32 a MoE layer), and
    the admission exchanges nothing."""
    j, key = runs.jax, f"{name}/2x1"
    n = sc.B // 2
    for r in runs.world2:
        got = r["cases"]["2x1"]["serve"][name]
        want = got["ref"]
        assert _rows_rel(got["prefill_logits"], want["prefill_logits"]) < PREFILL_TOL
        for k in ("decode_logits", "slot_logits"):
            assert _rows_rel(got[k], want[k]) < DECODE_TOL, k
        for k in ("tokens", "slot_tokens"):
            assert all(np.array_equal(a, b) for a, b in zip(got[k], want[k])), k
        assert np.array_equal(got["slot_token"], want["slot_token"])
        for k in ("prefill_cache", "decode_cache", "slot_cache", "final_cache"):
            _caches_close(got["cache_keys"], got[k], want[k],
                          decoded=k not in ("prefill_cache", "slot_cache"))
        for k in ("prefill", "decode", "slot"):
            assert got[f"{k}_bytes"] == got["modeled"][k], k
        assert got["prefill_bytes"]["fwd"] > 0 and got["decode_bytes"]["fwd"] > 0
        assert got["slot_bytes"]["fwd"] == 0  # an admission exchanges nothing over data
        rows = slice(got["dp_index"] * n, (got["dp_index"] + 1) * n)
        assert _rows_rel(got["prefill_logits"], j[f"{key}/logits"][rows]) < JAX_TOL
        for s in range(sc.STEPS):
            assert np.array_equal(got["tokens"][s], j[f"{key}/tokens{s}"][rows]), s
        nleaves = len(got["cache_keys"])
        for k in ("prefill_cache", "decode_cache"):
            _caches_close(got["cache_keys"], got[k],
                          [j[f"{key}/{k}{i}"][:, rows] for i in range(nleaves)],
                          decoded=k == "decode_cache")


# ---------------------------------------------------------------------------
# qwen2-vl and whisper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sc.FIXED)
@pytest.mark.parametrize("mesh", sc.FIXED_MESHES)
def test_vlm_and_encdec_serve_match_tp1(runs, mesh, name):
    """qwen2-vl (embeddings at image-then-text M-RoPE positions), whisper
    (tokens and encoder frames) and whisper with 6 heads under opt-seq
    (sequence-sharded where TP = 4 cuts a head) served on the mesh
    against the port at TP = 1 on the rank's rows: prefill logits within
    1e-5 of the row's max, the last decode step's within 1e-4, the
    greedy tokens equal, the gathered caches (``enc`` included) by the
    module docstring's rules; the logits and every cache leaf a rank
    holds whole bit-equal across a TP group; the payload of the prefill
    and a decode step equal to ``modeled_tp_serve_bytes``."""
    for r in _ranks(runs, mesh):
        got, want = r["fixed"][name], r["fixed"][name]["ref"]
        assert _rows_rel(got["prefill_logits"], want["prefill_logits"]) < PREFILL_TOL
        assert _rows_rel(got["decode_logits"], want["decode_logits"]) < DECODE_TOL
        assert all(np.array_equal(a, b) for a, b in zip(got["tokens"], want["tokens"]))
        for k in ("prefill_cache", "decode_cache", "final_cache"):
            _caches_close(got["cache_keys"], got[k], want[k], decoded=k != "prefill_cache")
        for k in ("prefill", "decode"):
            assert got[f"{k}_bytes"] == got["modeled"][k], k
    _tp_groups_agree(runs, mesh, name, ("prefill_logits", "decode_logits"), kind="fixed")
    groups: dict = {}
    for r in _ranks(runs, mesh):
        groups.setdefault(r["fixed"][name]["dp_index"], []).append(r["fixed"][name])
    for members in groups.values():
        first = members[0]
        assert "enc" not in first["cache_keys"] or first["cache_replicated"][
            first["cache_keys"].index("enc")]
        for other in members[1:]:
            for rep, a, b in zip(first["cache_replicated"], first["local_cache"],
                                 other["local_cache"]):
                assert not rep or np.array_equal(a, b)


@pytest.mark.parametrize("key", list(JAX_FIXED))
def test_vlm_and_encdec_serve_match_jax_sharded(runs, key):
    """The same traffic against JAX's jitted prefill and decode with
    ``NamedSharding``s from ``param_pspecs``/``cache_pspecs`` on the same
    mesh (the opt-seq edge: JAX's ``attn_seq_shard`` layout), f32
    compute: prefill logits within 1e-4 of the row's max and the
    prefill's cache by the module docstring's rules; whisper's 4 greedy
    tokens and decoded cache too; qwen2-vl's one scalar M-RoPE decode
    step in bf16 compute from each side's prefill cache within 5e-2 of
    the row's max (JAX writes its bf16 cache at a scalar position only
    in bf16 compute)."""
    name, mesh = JAX_FIXED[key]
    n = sc.B // MESHES[mesh][0]
    j = runs.jax
    for r in _ranks(runs, mesh):
        got = r["fixed"][name]
        rows = slice(got["dp_index"] * n, (got["dp_index"] + 1) * n)
        nleaves = len(got["cache_keys"])
        assert _rows_rel(got["prefill_logits"], j[f"{key}/logits"][rows]) < JAX_TOL
        _caches_close(got["cache_keys"], got["prefill_cache"],
                      [_jax_rows(j[f"{key}/prefill_cache{i}"], k, rows)
                       for i, k in enumerate(got["cache_keys"])], decoded=False)
        if f"{key}/bf16_decode_logits" in j:
            assert _rows_rel(got["bf16_decode_logits"],
                             j[f"{key}/bf16_decode_logits"][rows]) < FIXED_BF16_TOL
            continue
        for s in range(sc.STEPS):
            assert np.array_equal(got["tokens"][s], j[f"{key}/tokens{s}"][rows]), s
        _caches_close(got["cache_keys"], got["decode_cache"],
                      [_jax_rows(j[f"{key}/decode_cache{i}"], k, rows)
                       for i, k in enumerate(got["cache_keys"][:nleaves])], decoded=True)


def _jax_rows(x: np.ndarray, key: str, rows: slice) -> np.ndarray:
    """A DP rank's rows of a JAX cache leaf: the batch is axis 1 of a
    stacked layer leaf, axis 0 of whisper's ``enc``."""
    return x[rows] if key == "enc" else x[:, rows]


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
    ``tests/test_torch_specs.py``). whisper-tiny's 6 heads at TP = 4
    raise instead, naming ``attn_seq_shard``, and its ``opt-seq`` cells
    build there (:func:`test_opt_seq_cells_build_where_heads_do_not_divide`)."""
    dp, tp = MESHES[mesh]
    if arch == "whisper-tiny" and tp == 4:
        for r in _ranks(runs, mesh):
            for shape_name in sc.CELL_SHAPES:
                msg = r["meta_cells"][f"{arch}/{shape_name}"]["refused"]
                assert msg is not None and "attn_seq_shard" in msg and "num_heads=6" in msg
        return
    _meta_cells_hold_blocks(runs, mesh, arch, "baseline")


@pytest.mark.parametrize("arch", sc.OPT_SEQ_ARCHS)
def test_opt_seq_cells_build_where_heads_do_not_divide(runs, arch):
    """Every GQA arch's ``opt-seq`` prefill and decode cells (JAX's
    variant with ``attn_seq_shard``) build on ``(1, 4)`` on the meta
    device, whisper-tiny's 6 heads included, each arg the rank's block
    by the cell's specs as for the baseline cells."""
    _meta_cells_hold_blocks(runs, "1x4", arch, "opt-seq")


def _meta_cells_hold_blocks(runs, mesh, arch, variant) -> None:
    dp, tp = MESHES[mesh]
    suffix = "" if variant == "baseline" else f"/{variant}"
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
            got = r["meta_cells"][f"{arch}/{shape_name}{suffix}"]
            assert "refused" not in got, got.get("refused")
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
    take the global batch's capacity: its rank's rows are held against
    the TP = 1 cell of the whole batch. The ``long_smoke`` cell (one
    sequence on every rank, its cache's slots split over ``data``) is
    held against the TP = 1 cell of that sequence: every rank's token
    equal to it, the cache gathered over both axes by the decoded
    rule."""
    dp = MESHES[mesh][0]
    cfg = C.get_smoke_config(arch)
    with hints.set_mesh(None):
        keys = [p[-1] for p, _ in paths(T.init_cache(cfg, 1, 1, "meta"))]
    for r in _ranks(runs, mesh):
        for shape in sc.SMOKE_SHAPES:
            got = r["smoke_cells"][f"{arch}/{shape}"]
            if sc.SMOKE_SHAPES[shape][2] == 1:  # every rank decodes the one sequence
                want = runs.tp1_cells[f"{arch}/{shape}/1/0"]
            elif dp > 1 and arch in sc.MOE_ARCHS:
                whole = runs.tp1_cells[f"{arch}/{shape}/1/0"]
                n = sc.SMOKE_SHAPES[shape][2] // dp
                rows = slice(_dp_index(r) * n, (_dp_index(r) + 1) * n)
                want = {"out": whole["out"][rows], "cache": [x[:, rows] for x in whole["cache"]]}
            else:
                want = runs.tp1_cells[f"{arch}/{shape}/{dp}/{_dp_index(r)}"]
            if shape == "prefill_smoke":
                assert _rows_rel(got["out"], want["out"]) < PREFILL_TOL
            else:
                assert np.array_equal(got["out"], want["out"])
            _caches_close(keys, got["cache"], want["cache"], decoded=shape != "prefill_smoke")


def _dp_index(r) -> int:
    return next(iter(r["serve"].values()))["dp_index"]


@pytest.mark.parametrize("name", list(sc.CELL_REFUSALS))
def test_unported_cells_raise_naming_their_entry(runs, name):
    """The cells once refused on a ``ProcessMesh`` with a live ``model``
    axis: qwen2-vl-7b's train and prefill cells, a flat-dispatch MoE
    arch's decode cell on ``(2, 2)`` (its capacity the global batch's)
    and mamba2-2.7b's ``long_500k`` cell (its one sequence replicated,
    a cache's slots split over ``data``) build now; whisper-tiny's 6
    heads at TP = 4 without ``attn_seq_shard`` raise naming the flag."""
    mesh, words = sc.CELL_REFUSALS[name][2:]
    for r in runs.world2 if mesh == "1x2" else runs.world4:
        msg = r["refusals"][name]
        if words is None:
            assert msg is None, msg
        else:
            assert msg is not None and all(w in msg for w in words), msg


# ---------------------------------------------------------------------------
# Long context: the sequence-parallel decode
# ---------------------------------------------------------------------------

# one decode step of the long-context configs from a seeded whole cache,
# in f32 compute, against the port on the whole cache and JAX's
# decode_step: the logits within LONG_TOL of the row's max (the softmax's
# max and sum reduced over the slot blocks in another order, then each
# normalised weight rounded to the bf16 cache's dtype as on the whole
# cache)
LONG_TOL = 1e-5


def _long_ranks(runs, mesh: str) -> list[dict]:
    return [r["cases"][mesh]["long"] for r in (runs.world4 if mesh == "2x2" else runs.world2)]


def _long_split(name: str, mesh: str) -> int:
    """The data ranks over which ``cache_pspecs`` splits ``name``'s
    slots on ``mesh``: its data size where the count divides by 16,
    else 1 (the cache whole on every rank)."""
    return SHAPES[mesh][0] if sc.long_slots(name) % 16 == 0 else 1


@pytest.mark.parametrize("name", sc.LONG_NAMES)
@pytest.mark.parametrize("mesh", sc.LONG_MESHES)
def test_long_decode_matches_whole_cache_and_jax(runs, mesh, name):
    """One decode step of ``name`` on every rank of the mesh, its cache's
    slots split over ``data`` (``(2, 1)``, ``(2, 2)``; whole at
    ``(1, 2)``, and whole everywhere for the window of 24 slots, which
    ``cache_pspecs`` does not split) under ``hints.replicated_batch``,
    from the seeded whole cache placed by ``cache_pspecs``, at position
    0 (only slot 0, on data rank 0, valid), at a position in the last
    data rank's block and past the ring's wrap (GQA; MLA has no wrap):
    the logits within 1e-5 of the row's max of the port's decode on the
    whole cache and of JAX's ``decode_step`` on it (both in f32
    compute), the greedy token equal, and the new cache gathered over
    the mesh (``gather_cache``) equal to JAX's new cache by the prefill
    rule of the module docstring (one bf16 rounding step a bf16 element,
    1e-5 of the scale for the SSM state). Each rank holds ``slots /
    data`` slots of each split leaf."""
    j = runs.jax
    split = _long_split(name, mesh)
    for r in _long_ranks(runs, mesh):
        got = r[name]
        keys = got["cache_keys"]
        for key, shape, whole in zip(keys, got["placed_shapes"], sc.long_cache(name)):
            if key in ("k", "v", "ckv", "krope"):
                assert shape[2] * split == whole.shape[2], (key, shape)
        for pos in sc.long_positions(name):
            mine, ref = got[pos], got["ref"][pos]
            want = j[f"long/{name}/{pos}/logits"]
            assert _rows_rel(mine["logits"], ref["logits"]) < LONG_TOL, pos
            assert _rows_rel(mine["logits"], want) < LONG_TOL, pos
            assert mine["token"] == int(want.argmax(-1)[0]) == int(ref["logits"].argmax(-1)[0])
            _caches_close(keys, mine["cache"],
                          [j[f"long/{name}/{pos}/cache{i}"] for i in range(len(keys))],
                          decoded=False)


@pytest.mark.parametrize("name", sc.LONG_NAMES)
@pytest.mark.parametrize("mesh", sc.LONG_MESHES)
def test_long_prefill_keeps_the_slot_blocks(runs, mesh, name):
    """A prefill of ``sc.LONG_PROMPT`` tokens under
    ``hints.replicated_batch`` on every rank of the mesh, where the
    decode cache's slots are split over ``data``: the rank prefills the
    whole replicated row and keeps its block of the cache's slots
    (``cache_pspecs``' split), so the cache gathered over the mesh equals
    the port's prefill with no mesh and JAX's ``prefill`` by the prefill
    rule of the module docstring, and the logits are within 1e-5 of the
    row's max of both (f32 compute)."""
    j = runs.jax
    split = _long_split(name, mesh)
    for r in _long_ranks(runs, mesh):
        got, ref = r[name]["prefill"], r[name]["ref_prefill"]
        keys = r[name]["cache_keys"]
        assert _rows_rel(got["logits"], ref["logits"]) < LONG_TOL
        assert _rows_rel(got["logits"], j[f"long/{name}/prefill/logits"]) < LONG_TOL
        for key, shape, whole in zip(keys, got["shapes"], ref["cache"]):
            if key in ("k", "v", "ckv", "krope"):
                assert shape[2] * split == whole.shape[2], (key, shape)
        _caches_close(keys, got["cache"], ref["cache"], decoded=False)
        _caches_close(keys, got["cache"],
                      [j[f"long/{name}/prefill/cache{i}"] for i in range(len(keys))],
                      decoded=False)


@pytest.mark.parametrize("name", sc.LONG_NAMES)
@pytest.mark.parametrize("mesh", sc.LONG_MESHES)
def test_long_decode_payload_is_the_combine_and_no_moe_exchange(runs, mesh, name):
    """The payload a rank hands the collectives of a long-context decode
    step equals ``modeled_tp_serve_bytes(slot_split=data)``: the model
    group's, plus each attention layer's softmax combine over the slot
    blocks (two ``(1, H)`` f32 reductions and one of ``(1, H, Dh)``;
    none where the slots stay whole), and nothing for a MoE layer (jamba's flat MoE): under the replicated
    token every capacity is taken for that one token (``capacity(cfg,
    1)``), with no exchange of counts over ``data``."""
    for r in _long_ranks(runs, mesh):
        got = r[name]
        for pos in sc.long_positions(name):
            assert got[pos]["bytes"] == got["modeled"], pos
            assert all(t == 1 for t in got[pos]["capacity_tokens"]), pos
            if name == "jamba-v0.1-52b":
                assert got[pos]["capacity_tokens"]
    if _long_split(name, mesh) > 1 and name != "mamba2-2.7b":
        assert _long_ranks(runs, mesh)[0][name]["modeled"]["fwd"] > 0


@pytest.mark.parametrize("arch", sc.LONG_CELL_ARCHS)
@pytest.mark.parametrize("mesh", sc.LONG_MESHES)
def test_long_cells_hold_the_slot_blocks(runs, mesh, arch):
    """``build_cell(arch, "long_500k", ProcessMesh)`` on the meta device
    for the three archs that run the shape: the params the rank's
    ``param_pspecs`` blocks, the one token whole (spec ``P()``), and
    each cache leaf its block by ``cache_pspecs`` of the shape: the
    batch whole, ``k``/``v`` split by slots over ``data`` (and by KV
    heads over ``model``), Mamba-2's ``conv`` in the rank's layout."""
    dp, tp = SHAPES[mesh]
    mesh_shape = {"data": dp, "model": tp}
    cfg = C.get_config(arch)
    shape = C.SHAPES["long_500k"]
    cache = C.input_specs(cfg, shape)["cache"]
    cspecs = shd.cache_pspecs(cache, cfg, shape, tp=tp)
    want = []
    for (path, x), spec in zip(paths(cache), leaves(cspecs)):
        block = _block_shape(x.shape, spec, mesh_shape)
        if path[-1] == "conv" and cfg.d_inner % tp == 0:
            block = block[:-1] + (cfg.d_inner // tp + 2 * cfg.ssm_ngroups * cfg.ssm_state,)
        if path[-1] in ("k", "v"):
            assert block[2] * dp == x.shape[2]
        want.append(block)
    for r in (runs.world4 if mesh == "2x2" else runs.world2):
        cells = r["cases"][mesh]["meta_cells"]
        got = cells[f"{arch}/long_500k"]
        assert got["args"][1:3] == [[(1,)], [()]]
        assert got["args"][3] == want
        assert got["in_specs"][-len(want):] == [str(keep_axes(s, ("data", "model")))
                                               for s in leaves(cspecs)]


def test_place_cache_refuses_slots_the_data_size_does_not_divide():
    """A long-context cache whose slots the ``data`` size does not divide
    cannot be placed: 64 slots over 3 data ranks raise ``ValueError``
    (as JAX's ``device_put`` of the spec would)."""
    cfg = sc.config("jamba-v0.1-52b")
    shape = Shape(sc.LONG_SHAPE, "decode", sc.LONG_SLOTS, 1)
    with hints.set_mesh(None):
        cache = T.init_cache(cfg, 1, sc.LONG_SLOTS, device="meta")
    specs = shd.cache_pspecs(cache, cfg, shape, tp=1)
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 3, "model": 1},
                                 coords={"data": 1, "model": 0})
    with pytest.raises(ValueError, match="does not split into 3"):
        shd.place_cache(cache, specs, cfg, mesh)
