"""The port's serving path against ``repro.launch``: paged-KV packing,
seeding and relayout (bit-exact given the same cache), and a port
``Server`` beside a JAX ``Server`` with the same weights and requests —
identical weight-multicast bytes, KV-multicast records and scale-down
chains, and the same greedy tokens.

Tokens: the two frameworks round bf16 at different places (see
``tests/test_torch_model.py``), so logits agree within ``LOGIT_REL`` of
their scale, not bit for bit. Where a greedy token differs, the test
shows that JAX's own top-2 logit margin at that step is within twice
that tolerance — i.e. the two candidates were tied at bf16 precision.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import paged_kv as JK  # noqa: E402
from repro.launch.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.launch.serve import Server as JServer  # noqa: E402
from repro.launch.steps import make_slot_prefill_step  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import paged_kv as TK  # noqa: E402
from repro_torch.launch.serve import ServeConfig, Server  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from repro import configs as JC  # noqa: E402

MAX_SEQ = 48
LOGIT_REL = 5e-2


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.fixture(scope="module")
def jax_prefill():
    cfg = JC.get_smoke_config("yi-6b")
    params = JT.model_init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, 16).astype(np.int32)
    _, one_cache = jax.jit(make_slot_prefill_step(cfg, MAX_SEQ))(params, jnp.asarray(tokens)[None])
    return cfg, one_cache


def test_extract_seed_and_paged_are_bit_exact_vs_jax(jax_prefill):
    cfg, jcache = jax_prefill
    tcache = params_from_numpy(jax.device_get(jcache), "cpu")
    plen = 16
    assert TK.kv_feature_width(tcache, MAX_SEQ) == JK.kv_feature_width(jcache, MAX_SEQ)
    jd = JK.extract_dense_kv(jcache, 0, plen, MAX_SEQ)
    td = TK.extract_dense_kv(tcache, 0, plen, MAX_SEQ)
    assert td.dtype == TK.BF16 and tuple(td.shape) == jd.shape
    np.testing.assert_array_equal(_bits(td), _bits(jd))

    jfresh = JT.init_cache(cfg, 3, MAX_SEQ)
    tfresh = params_from_numpy(jax.device_get(jfresh), "cpu")
    jseeded = JK.seed_cache_row(jfresh, 2, jd, 13)
    tseeded = TK.seed_cache_row(tfresh, 2, td, 13)
    for j, t in zip(jax.tree.leaves(jseeded["layers"]), leaves(tseeded["layers"])):
        np.testing.assert_array_equal(_bits(t), _bits(j))

    for page in (4, 8, 16):
        tp = TK.to_paged(td, page)
        np.testing.assert_array_equal(_bits(tp), _bits(JK.to_paged(jd, page)))
        np.testing.assert_array_equal(_bits(TK.paged_ref(td, page)), _bits(JK.paged_ref(jd, page)))
    wire = td.reshape(-1).view(torch.uint8)
    np.testing.assert_array_equal(_bits(TK.dense_from_bytes(wire, plen, td.shape[1])), _bits(jd))
    with pytest.raises(ValueError):
        TK.to_paged(td, 5)


def test_seed_rejects_width_mismatch(jax_prefill):
    cfg, jcache = jax_prefill
    tcache = params_from_numpy(jax.device_get(jcache), "cpu")
    dense = TK.extract_dense_kv(tcache, 0, 8, MAX_SEQ)
    with pytest.raises(ValueError):
        TK.seed_cache_row(tcache, 0, dense[:, :-1], 8)


def _requests(rng, prefix, vocab):
    out = []
    for i in range(5):
        if i % 2 == 0:
            p = np.concatenate([prefix, rng.integers(0, vocab, 4).astype(np.int32)])
        else:
            p = rng.integers(0, vocab, 20).astype(np.int32)
            p[0] = (prefix[0] + 1) % vocab
        out.append((p, i))
    out.append((prefix.copy(), 2))  # prompt == prefix: the last token re-feeds
    return out


def _jax_logits_along_serve_path(jserver, jr, k, prefix_len):
    """JAX's logits for request ``jr``'s ``k``-th output token, computed
    one row at a time along the path its server took: a miss prefills
    the prompt; a prefix hit prefills the seeded prefix and feeds the
    rest of the prompt through decode steps; then ``jr.out[:k]`` are fed
    through decode steps. (A full prefill of prompt and outputs is not
    that path for a MoE arch: its capacity is computed over the whole
    sequence, so it can drop assignments the decode steps keep.)"""
    cfg, params = jserver.cfg, jserver.params
    prompt = np.asarray(jr.prompt, np.int32)
    seed = (min(prefix_len, prompt.size - 1) if jr.prefix_hit else prompt.size)
    logits, cache = JT.prefill(params, cfg, {"tokens": jnp.asarray(prompt[:seed])[None]},
                               MAX_SEQ)
    fed = list(prompt[seed:]) + list(jr.out[:k])
    for i, t in enumerate(fed):
        logits, cache = JT.decode_step(params, cfg, jnp.asarray([t], jnp.int32),
                                       jnp.asarray([seed + i], jnp.int32), cache)
    return np.asarray(logits[0])


def _check_tokens(jserver, jreqs, treqs, prefix_len):
    """Same greedy tokens, or a divergence where JAX itself had a tie."""
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.out) == len(jr.out) and tr.prefix_hit == jr.prefix_hit
        diff = [k for k, (a, b) in enumerate(zip(jr.out, tr.out)) if a != b]
        if not diff:
            continue
        k = diff[0]
        top = np.sort(_jax_logits_along_serve_path(jserver, jr, k, prefix_len))[::-1]
        assert top[0] - top[1] <= 2 * LOGIT_REL * np.abs(top).max(), (jr.rid, k, top[:2])


# a mamba layer's cache has no per-position axis: KV-prefix multicast is
# not defined for it, and both packages' register_prefix refuse it
NO_KV_MULTICAST = ("mamba2-2.7b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", ["yi-6b", "llama3-8b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
                                  *NO_KV_MULTICAST])
def test_server_matches_jax_server(arch):
    """Without a prefix for an arch with mamba layers: every request is
    then a miss."""
    sc = dict(arch=arch, smoke=True, batch=2, prompt_len=24, max_seq=MAX_SEQ,
              replicas=4, page_size=8)
    js = JServer(JServeConfig(**sc))
    ts = Server(ServeConfig(**sc), device="cpu")

    # weights: the JAX server's, carried across; identical wire bytes
    jrec = js.broadcast_weights(chunk_bytes=1 << 16)
    trec = ts.broadcast_weights(
        chunk_bytes=1 << 16, new_params=params_from_numpy(jax.device_get(js.params), "cpu")
    )
    assert trec == jrec
    assert sorted(ts.last_delivery) == sorted(js.last_delivery) == [1, 2, 3]
    for d, buf in js.last_delivery.items():
        np.testing.assert_array_equal(ts.last_delivery[d].numpy(), buf)

    # KV-prefix multicast: identical records, each replica's pages pinned
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, js.cfg.vocab_size, 16).astype(np.int32)
    kv = arch not in NO_KV_MULTICAST
    if kv:
        jentry = js.register_prefix(prefix)
        tentry = ts.register_prefix(prefix)
        assert tentry.broadcast == jentry.broadcast
        assert sorted(tentry.replica_paged) == [0, 1, 2, 3]
        for pages in tentry.replica_paged.values():
            np.testing.assert_array_equal(_bits(pages), _bits(TK.paged_ref(tentry.dense, 8)))
        np.testing.assert_allclose(tentry.dense.float().numpy(),
                                   np.asarray(jentry.dense, np.float32), atol=5e-2, rtol=5e-2)

    reqs = _requests(rng, prefix, js.cfg.vocab_size)
    jreqs = [js.submit(p, 6, arrival=a) for p, a in reqs]
    treqs = [ts.submit(p, 6, arrival=a) for p, a in reqs]
    jout, tout = js.run(jreqs), ts.run(treqs)
    for key in ("requests", "served", "generated_tokens", "decode_steps", "prefix_hit_rate",
                "prefix_entries", "prefix_bytes", "latency_ticks_p50", "latency_ticks_p99",
                "weight_multicast", "kv_multicast"):
        assert tout[key] == jout[key], key
    assert [r.prefix_hit for r in treqs] == (
        [True, False, True, False, True, True] if kv else [False] * 6)
    _check_tokens(js, jreqs, treqs, prefix.size)

    # elastic scale-down: the same lost ids and re-formed chains, and the
    # next refresh reaches exactly the survivors
    assert ts.scale_down(2) == js.scale_down(2) == (2, 3)
    assert ts.plan.chains == js.plan.chains
    assert ts.broadcast_weights(chunk_bytes=1 << 18) == js.broadcast_weights(chunk_bytes=1 << 18)
    assert list(ts.last_delivery) == [1]
    np.testing.assert_array_equal(ts.last_delivery[1].numpy(), js.last_delivery[1])


@pytest.mark.parametrize("arch", NO_KV_MULTICAST)
def test_register_prefix_refuses_mamba_caches_like_jax(arch):
    """Both packages' servers refuse a prefix for a model with mamba
    layers (its conv/ssm cache leaves have no per-position axis) with
    ``ValueError``, and register nothing: the prefix cache, the KV
    multicast log and every replica's cache stay as they were."""
    sc = dict(arch=arch, smoke=True, batch=2, prompt_len=24, max_seq=MAX_SEQ, replicas=4,
              page_size=8)
    js, ts = JServer(JServeConfig(**sc)), Server(ServeConfig(**sc), device="cpu")
    before = [t.clone() for t in leaves(ts.cache)]
    prefix = np.random.default_rng(5).integers(0, ts.cfg.vocab_size, 16).astype(np.int32)
    for server in (js, ts):
        with pytest.raises(ValueError, match="per-position"):
            server.register_prefix(prefix)
        assert server.prefix_cache.entries == [] and server.kv_multicast_log == []
        assert server.prefix_cache.total_bytes == 0
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(ts.cache)))
    assert {"conv", "ssm"} <= {k for g in ts.cache["layers"] for p in g for k in p}


def test_single_replica_records_are_noops():
    ts = Server(ServeConfig(batch=2, prompt_len=24, max_seq=MAX_SEQ, replicas=1), device="cpu")
    rec = ts.broadcast_weights()
    assert rec["noop"] and rec["chunks"] == rec["delivered_bytes"] == 0
    entry = ts.register_prefix(np.arange(8, dtype=np.int32))
    assert entry.broadcast["noop"] and list(entry.replica_paged) == [0]


def test_register_prefix_and_submit_reject_bad_lengths():
    ts = Server(ServeConfig(batch=2, prompt_len=24, max_seq=MAX_SEQ, replicas=2), device="cpu")
    for bad in (np.arange(12), np.zeros(0), np.arange(MAX_SEQ)):
        with pytest.raises(ValueError):
            ts.register_prefix(bad.astype(np.int32))
    with pytest.raises(ValueError):
        ts.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="refusing to truncate"):
        ts.submit(np.zeros(25, np.int32), 4)


def test_server_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(ServeConfig())


def _entry(tokens, rows=16, width=4):
    d = torch.zeros((rows, width), dtype=TK.BF16)
    return TK.PrefixEntry(tokens=np.asarray(tokens, np.int32), page=8, dense=d, paged=d[None])


def test_prefix_cache_lru_and_invalidation_match_jax():
    """The port's PrefixCache makes the same decisions as the JAX one."""
    caps = (None, 2 * _entry(np.arange(8)).nbytes)
    for cap in caps:
        tc, jc = TK.PrefixCache(capacity_bytes=cap), JK.PrefixCache(capacity_bytes=cap)
        ops = [("add", np.arange(8)), ("add", np.arange(100, 108)),
               ("lookup", np.arange(10)), ("add", np.arange(200, 216)),
               ("lookup", np.arange(100, 110)), ("update", None),
               ("add", np.arange(8)), ("lookup", np.arange(12)), ("lookup", [5, 1])]
        for op, arg in ops:
            if op == "add":
                tc.add(_entry(arg))
                jd = np.zeros((16, 4), JK.BF16)
                jc.add(JK.PrefixEntry(tokens=np.asarray(arg, np.int32), page=8, dense=jd,
                                      paged=jd[None]))
            elif op == "lookup":
                t, j = tc.lookup(np.asarray(arg)), jc.lookup(np.asarray(arg))
                assert (t is None) == (j is None)
                assert t is None or t.plen == j.plen
            else:
                assert tc.on_weights_update() == jc.on_weights_update()
            assert [e.plen for e in tc.entries] == [e.plen for e in jc.entries]
            assert tc.total_bytes == jc.total_bytes
        assert (tc.hits, tc.misses, tc.evictions, tc.invalidations) == (
            jc.hits, jc.misses, jc.evictions, jc.invalidations)
        assert tc.hit_rate == jc.hit_rate
    with pytest.raises(ValueError):
        TK.PrefixCache(capacity_bytes=0)
