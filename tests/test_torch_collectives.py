"""The port's gradient reduction and ring-collective seam
(``repro_torch.parallel.collectives``) against ``repro.parallel.
collectives`` and numpy twins built on ``chainwrite_ref``.

Bucket assembly (``assign_buckets``, ``bucket_shard_layout``,
``all_reduce_shards``, ``resolve_ring_chains``) must equal JAX's. The
reduction itself is held bit for bit (no tolerance): bucketed equals
per-leaf at the exact wire for K in {1, 2, 4, "auto"} x both algos x 4
bucket sizes, both equal a numpy twin that replays the JAX package's
order (flat leaf, EF residual added before the int8 wire, ring
all-reduce by ``multi_all_reduce_ref``, divide by the DP size), the
hierarchical (pod, data) reduction equals the two-stage oracle, and the
error-feedback residuals equal the twin's. Metrics are averaged over
ranks (f32 sums, tolerance 1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import chainwrite_ref as ref  # noqa: E402
from repro.parallel import collectives as J  # noqa: E402

from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.parallel import collectives as TC  # noqa: E402

SHAPES = [(33, 7), (5,), (128, 64), (1000,), (3, 3, 3), (17,), (64, 2)]


def _leaves(dtypes=None):
    dtypes = dtypes or [np.float32] * len(SHAPES)
    return [np.zeros(s, d) for s, d in zip(SHAPES, dtypes)]


@pytest.mark.parametrize("target", [1, 64, 4096, 40000, 1 << 20])
@pytest.mark.parametrize("mixed", [False, True])
def test_assign_buckets_matches_jax(target, mixed):
    dts = [np.float32, np.float32, np.float16, np.float16, np.float32, np.float32,
           np.float32] if mixed else None
    arrs = _leaves(dts)
    jb = J.assign_buckets([jax.ShapeDtypeStruct(a.shape, a.dtype) for a in arrs], target)
    tb = TC.assign_buckets([torch.from_numpy(a) for a in arrs], target)
    assert [(b.indices, b.dtype, b.num_bytes) for b in tb] == [
        (b.indices, b.dtype, b.num_bytes) for b in jb]
    with pytest.raises(ValueError):
        TC.assign_buckets([torch.zeros(3)], 0)


@pytest.mark.parametrize("L", [2, 4, 8, 16])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("algo", ["rs_ag", "rotation"])
def test_all_reduce_shards_matches_jax(L, k, algo):
    if L % k:
        return
    assert TC.all_reduce_shards(L, k, algo) == J.all_reduce_shards(L, k, algo)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_bucket_shard_layout_matches_jax(shards):
    sizes = [231, 5, 1, 4096, 97]
    assert TC.bucket_shard_layout(sizes, shards) == J.bucket_shard_layout(sizes, shards)


@pytest.mark.parametrize("L", [2, 4, 8])
@pytest.mark.parametrize("num_chains", [1, 2, 4, "auto"])
@pytest.mark.parametrize("nbytes", [64, 1 << 20, 1 << 28])
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("topology", [None, "pods=2:interpod_bw=0.25"])
def test_resolve_ring_chains_matches_jax(L, num_chains, nbytes, wire, topology):
    if isinstance(num_chains, int) and L % num_chains:
        return
    kw = dict(num_chains=num_chains, wire_dtype=wire, topology=topology)
    assert TC.resolve_ring_chains(L, nbytes, **kw) == J.resolve_ring_chains(L, nbytes, **kw)


@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 12])
def test_ring_orders_match_jax(L):
    for sched in ("tsp", "greedy", "naive"):
        assert TC.ring_order_for_axis(L, sched) == J.ring_order_for_axis(L, sched)
    for k in (1, 2, 3, 4):
        if L % k == 0:
            assert TC.sub_ring_orders(L, k) == J.sub_ring_orders(L, k)


def _stacked(dp, seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((dp,) + s).astype(np.float32) for s in shapes]


def _twin_reduce(stacked, dp, *, num_chains, algo, wire=None, residual=None,
                 bucket_bytes=None):
    """Numpy twin of the JAX package's reduction order on the stacked
    view: returns (grads, new residuals)."""
    out, new_res = [None] * len(stacked), [None] * len(stacked)
    flats = []
    for i, g in enumerate(stacked):
        f = g.reshape(dp, -1).astype(np.float32)
        if residual is not None:
            f = f + residual[i].reshape(dp, -1)
            deq = np.stack([ref._dequantize_ref(*ref._quantize_ref(row)) for row in f])
            new_res[i] = (f - deq).reshape(g.shape)
        flats.append(f)

    def ar(x):
        k, rings = J.resolve_ring_chains(dp, x[0].nbytes, num_chains=num_chains,
                                         algo=algo, wire_dtype=wire)
        return ref.multi_all_reduce_ref(x, rings, algo, wire)

    if bucket_bytes is None:
        for i, f in enumerate(flats):
            out[i] = (ar(f)[0] / np.float32(dp)).reshape(stacked[i].shape[1:])
        return out, new_res
    for b in J.assign_buckets([jax.ShapeDtypeStruct(g.shape[1:], g.dtype)
                               for g in stacked], bucket_bytes):
        fl = [flats[i] for i in b.indices]
        nbytes = sum(f[0].nbytes for f in fl)
        k, _ = J.resolve_ring_chains(dp, nbytes, num_chains=num_chains, algo=algo,
                                     wire_dtype=wire)
        shards = J.all_reduce_shards(dp, k, algo)
        widths, _ = J.bucket_shard_layout([f.shape[1] for f in fl], shards)
        padded = [np.pad(f, ((0, 0), (0, shards * m - f.shape[1]))).reshape(dp, shards, m)
                  for f, m in zip(fl, widths)]
        payload = np.concatenate(padded, axis=2).reshape(dp, -1)
        kk, rings = J.resolve_ring_chains(dp, nbytes, num_chains=num_chains, algo=algo,
                                          wire_dtype=wire)
        mat = ref.multi_all_reduce_ref(payload, rings, algo, wire).reshape(dp, shards, -1)
        off = 0
        for i, f, m in zip(b.indices, fl, widths):
            row = mat[0, :, off:off + m].reshape(-1)[: f.shape[1]]
            out[i] = (row / np.float32(dp)).reshape(stacked[i].shape[1:])
            off += m
    return out, new_res


@pytest.mark.parametrize("num_chains", [1, 2, 4, "auto"])
@pytest.mark.parametrize("algo", ["rs_ag", "rotation"])
@pytest.mark.parametrize("bucket_bytes", [1, 2048, 30000, 1 << 22])
def test_bucketed_equals_per_leaf_and_twin(num_chains, algo, bucket_bytes):
    dp = 8
    mesh = make_host_mesh(data=dp)
    stacked = _stacked(dp, 1)
    kw = dict(num_chains=num_chains, algo=algo)
    per_leaf = TC.make_stacked_reduce(mesh, **kw)([torch.from_numpy(s) for s in stacked])
    bucketed = TC.make_stacked_reduce(mesh, bucket_bytes=bucket_bytes, **kw)(
        [torch.from_numpy(s) for s in stacked])
    twin, _ = _twin_reduce(stacked, dp, **kw)
    twin_b, _ = _twin_reduce(stacked, dp, bucket_bytes=bucket_bytes, **kw)
    # "auto" resolves K per leaf on one path and per bucket on the other;
    # the fold order (and so the bits) is shared where the two agree
    k_of = lambda nbytes: TC.resolve_ring_chains(dp, nbytes, **kw)[0]  # noqa: E731
    same_k = [True] * len(stacked)
    for b in TC.assign_buckets([torch.from_numpy(s[0]) for s in stacked], bucket_bytes):
        kb = k_of(sum(stacked[i][0].nbytes for i in b.indices))
        for i in b.indices:
            same_k[i] = kb == k_of(stacked[i][0].nbytes)
    if num_chains != "auto":
        assert all(same_k)
    assert any(same_k)
    for a, b, w, wb, same in zip(per_leaf, bucketed, twin, twin_b, same_k):
        assert np.array_equal(a.numpy(), w) and np.array_equal(b.numpy(), wb)
        if same:
            assert torch.equal(a, b)


@pytest.mark.parametrize("num_chains", [1, 2, "auto"])
@pytest.mark.parametrize("bucket_bytes", [None, 4096])
def test_int8_ef_reduce_matches_twin(num_chains, bucket_bytes):
    """int8 wire with error feedback: grads and the new per-rank
    residuals equal the numpy twin bit for bit, per leaf and bucketed."""
    dp = 4
    mesh = make_host_mesh(data=dp)
    stacked = _stacked(dp, 2)
    residual = [r * np.float32(1e-2) for r in _stacked(dp, 3)]
    red = TC.make_stacked_reduce(mesh, num_chains=num_chains, wire_dtype="int8",
                                 error_feedback=True, bucket_bytes=bucket_bytes)
    res_t = [torch.from_numpy(r.copy()) for r in residual]
    got = red([torch.from_numpy(s.copy()) for s in stacked], res_t)
    want, want_res = _twin_reduce(stacked, dp, num_chains=num_chains, algo="rs_ag",
                                  wire="int8", residual=residual,
                                  bucket_bytes=bucket_bytes)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    for r, w in zip(res_t, want_res):
        assert np.array_equal(r.numpy(), w)


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("bucket_bytes", [None, 4096])
def test_hierarchical_two_axes_equals_two_stage_oracle(wire, bucket_bytes):
    """(pod=2, data=4): within each pod, then across pods, each stage
    the oracle's all-reduce of that axis (rank = pod * 4 + data)."""
    mesh = make_mesh((2, 4), ("pod", "data"))
    stacked = _stacked(8, 4, [(48,), (7, 3)])
    red = TC.make_stacked_reduce(mesh, wire_dtype=wire, bucket_bytes=bucket_bytes)
    got = red([torch.from_numpy(s) for s in stacked])
    for g, s in zip(got, stacked) if bucket_bytes is None else ():
        x = s.reshape(2, 4, -1)
        inner = np.stack([ref.multi_all_reduce_ref(
            x[p], (J.ring_order_for_axis(4),), wire_dtype=wire) for p in range(2)])
        outer = np.empty_like(inner)
        for d in range(4):
            outer[:, d] = ref.multi_all_reduce_ref(inner[:, d], ((0, 1),), wire_dtype=wire)
        want = (outer.reshape(8, -1)[0] / np.float32(8)).reshape(s.shape[1:])
        assert np.array_equal(g.numpy(), want)
    if wire is None:
        flat = TC.make_stacked_reduce(mesh, hierarchical=False)(
            [torch.from_numpy(s) for s in stacked])
        for g, f, s in zip(got, flat, stacked):
            assert np.allclose(g.numpy(), s.mean(0), atol=1e-6)
            assert np.allclose(f.numpy(), s.mean(0), atol=1e-6)


def test_torrent_grad_reduce_splits_batch_and_averages_metrics():
    """The wrapper runs grad_fn once per rank on its rows of the batch
    (P('data', None)) and averages the metrics over ranks."""
    dp = 4
    mesh = make_host_mesh(data=dp)
    seen = []

    def grad_fn(params, batch):
        seen.append(batch["x"].clone())
        g = batch["x"].sum(0) * params["w"]
        return {"w": g, "b": [g[:2] * 2]}, {"loss": batch["x"].mean()}

    params = {"w": torch.ones(6), "b": [torch.zeros(2)]}
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    grads, metrics = TC.torrent_grad_reduce(grad_fn, mesh, num_chains=2)(params, {"x": x})
    assert [tuple(s.shape) for s in seen] == [(2, 6)] * 4
    assert torch.equal(torch.cat(seen), x)
    per_rank = x.reshape(4, 2, 6).sum(1)
    assert torch.allclose(grads["w"], per_rank.mean(0))
    assert torch.allclose(grads["b"][0], per_rank.mean(0)[:2] * 2)
    assert abs(float(metrics["loss"]) - float(x.mean())) < 1e-5


def test_torrent_grad_reduce_error_feedback_signature():
    mesh = make_host_mesh(data=2)
    params = {"w": torch.zeros(5)}

    def grad_fn(p, batch):
        return {"w": batch["g"][0]}, {"loss": torch.tensor(0.0)}

    res = TC.ef_residual_init(params, 2)
    assert res["w"].shape == (2, 5) and res["w"].dtype == torch.float32
    red = TC.torrent_grad_reduce(grad_fn, mesh, wire_dtype="int8", error_feedback=True)
    g = torch.tensor([[1.0, -2.0, 3.0, 0.01, 0.0], [0.5, 0.5, -1.0, 0.02, 7.0]])
    grads, _, new_res = red(params, {"g": g}, res)
    assert new_res is res and float(res["w"].abs().max()) > 0
    assert torch.allclose(grads["w"], g.mean(0), atol=0.1)


def test_knob_validation_matches_jax():
    mesh = make_host_mesh(data=4)
    fn = lambda p, b: (p, {})  # noqa: E731
    for kw in ({"algo": "tree"}, {"num_chains": 1.5}, {"error_feedback": True},
               {"bucket_bytes": 0}, {"wire_dtype": "fp4"}):
        with pytest.raises(ValueError):
            TC.torrent_grad_reduce(fn, mesh, **kw)
        with pytest.raises(ValueError):
            J.torrent_grad_reduce(fn, None, None, **kw)
    with pytest.raises(NotImplementedError, match="ProcessMesh"):
        make_host_mesh(data=2, model=2)


@pytest.mark.parametrize("num_chains", [1, 2, 4])
@pytest.mark.parametrize("wire", [None, "int8"])
def test_torrent_ring_collectives_match_oracles(num_chains, wire):
    L = 8
    orders = ((J.ring_order_for_axis(L),) if num_chains == 1
              else tuple(J.sub_ring_orders(L, num_chains)))
    rng = np.random.default_rng(num_chains)
    xs = rng.standard_normal((L, L, 3)).astype(np.float32)
    got = TC.torrent_all_to_all(torch.from_numpy(xs), num_chains=num_chains, wire_dtype=wire)
    assert np.array_equal(got.numpy(), ref.multi_all_to_all_ref(xs, orders, wire))
    got = TC.torrent_reduce_scatter(torch.from_numpy(xs), num_chains=num_chains)
    assert np.array_equal(got.numpy(), ref.multi_reduce_scatter_ref(xs, orders))
    got = TC.torrent_all_gather(torch.from_numpy(xs[:, 0]), num_chains=num_chains, tiled=True)
    assert np.array_equal(got.numpy(), ref.multi_all_gather_ref(xs[:, 0], orders, True))


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device the executor does not run on (an
    ``xpu`` wrapper with no storage; any op on it fails)."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=torch.float32,
                                                   device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} reached a tensor on an unknown device")


def test_reduce_and_executor_refuse_mixed_or_unknown_devices():
    """Leaves on several devices raise instead of being reduced on one of
    them (``meta`` stands in for a second device on the CPU). The
    executor refuses a device it does not run on (an ``xpu`` wrapper
    tensor stands in for one); ``meta`` it runs on, for the dry run,
    recording the CPU run's bytes."""
    mesh = make_host_mesh(data=2)
    red = TC.make_stacked_reduce(mesh)
    with pytest.raises(ValueError, match="several devices"):
        red([torch.zeros((2, 3)), torch.zeros((2, 3), device="meta")])
    red_ef = TC.make_stacked_reduce(mesh, wire_dtype="int8", error_feedback=True)
    with pytest.raises(ValueError, match="several devices"):
        red_ef([torch.zeros((2, 3))], [torch.zeros((2, 3), device="meta")])
    with pytest.raises(ValueError, match="residual"):
        red_ef([torch.zeros((2, 3))])
    from repro_torch.core import chainwrite as cw

    with pytest.raises(ValueError, match="device"):
        cw.chain_all_reduce(_Elsewhere((2, 4)))
    cw.wire_counter.reset()
    assert cw.chain_all_reduce(torch.zeros((2, 4), device="meta")).shape == (2, 4)
    meta_bytes = cw.wire_counter.bytes
    cw.wire_counter.reset()
    cw.chain_all_reduce(torch.zeros((2, 4)))
    assert meta_bytes == cw.wire_counter.bytes > 0
