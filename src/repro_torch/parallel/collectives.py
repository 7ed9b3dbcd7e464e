"""Collectives backend seam of the port: "xla" (a plain mean over the
DP ranks) vs "torrent" (Chainwrite: explicitly scheduled rings) — the
port of ``repro.parallel.collectives``.

On a :class:`~repro_torch.launch.mesh.VirtualMesh` one process runs
every DP rank as a row of the stacked view (see ``core.chainwrite``):
:func:`torrent_grad_reduce` wraps a per-rank
``grad_fn(params, batch_slice) -> (grads, metrics)``, runs it once per
rank on that rank's rows of the global batch, writes each rank's grads
into its row of one preallocated ``(dp, *shape)`` buffer per leaf, and
reduces the rows with the chain all-reduce; :func:`torrent_joint_grad_reduce`
takes a grad function that runs every rank at once and returns those
stacked rows itself (the train step's expert-parallel forward, whose
MoE layers exchange tokens between the ranks). The reduction keeps the
JAX package's order exactly: per-leaf flat payloads (or chunk-aligned
buckets in reverse leaf order), the EF residual added before the int8
wire and the new residual ``flat - dequantize(quantize(flat))``, the
sum divided by the DP size, metrics averaged over ranks. Every knob is
there: ``num_chains`` (int or ``"auto"``), ``algo``, ``wire_dtype``,
``error_feedback``, ``bucket_bytes``, ``topology`` and ``hierarchical``
over two DP axes (``("pod", "data")``, rank ``pod·D + data``).

On a :class:`~repro_torch.launch.mesh.ProcessMesh` each process is one
rank, as a JAX ``shard_map`` device is (``core.chainwrite_dist``):
:func:`torrent_grad_reduce` runs ``grad_fn`` on this rank's own rows,
reduces its grads over the mesh's process groups with the same
programs, in the same order, and averages the metrics with one
all-reduce. A leaf of this rank is the ``(1, *shape)`` row that the
stacked form holds at ``(dp, *shape)``, so the reduction code is one for
both, and a rank's reduced grads equal the stacked form's row of that
rank bit for bit. Under the int8 wire the rows differ (a shard's owner
keeps its f32 sum, the others dequantize its frame): each process
keeps its own, as each JAX device does, where the stacked form hands
every rank row 0.

:class:`MultiChainPlan` is the host-side multi-chain broadcast plan the
serving runtime holds; its :meth:`~MultiChainPlan.broadcast` runs the
(possibly degraded) multicast on the stacked view.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import chainwrite as cw
from repro_torch.core import chainwrite_dist as cwd
from repro_torch.core import program as prg
from repro_torch.core import simulator as sim
from repro_torch.core.scheduling import (
    SCHEDULERS,
    FailureSpec,
    normalize_failed,
    partition_schedule,
    reform_chain,
)
from repro_torch.core.simulator import SourceFailedError
from repro_torch.core.topology import MeshTopology, parse_topology_spec
from repro_torch.parallel.hints import dp_axes
from repro_torch.parallel.sharding import batch_axis
from repro_torch.parallel.spec import P
from repro_torch.runtime.compression import dequantize_rows, quantize_rows
from repro_torch.runtime.spans import maybe_span
from repro_torch.tree import leaves, map_tree, unflatten

PyTree = Any

class MultiChainPlan:
    """Host-side multi-chain broadcast plan with endpoint-only
    re-forming.

    The destination set is partitioned into K link-disjoint-preferring
    sub-chains (``core.scheduling.partition_schedule``). On a node
    failure, :meth:`reform` splices the dead member(s) — one node or a
    concurrent failure *set* — out of their sub-chains and re-orders
    each orphaned suffix (``core.scheduling.reform_chain``), so the next
    :meth:`broadcast` is the degraded multicast over the survivors.
    """

    def __init__(
        self,
        topo: MeshTopology,
        head: int,
        destinations,
        *,
        num_chains: int | None = None,
        scheduler: str = "tsp",
        max_chains: int = 4,
    ) -> None:
        self.topo = topo
        self.head = int(head)
        self.scheduler = scheduler
        self.chains: list[list[int]] = [
            list(c)
            for c in partition_schedule(
                topo, list(destinations), self.head,
                num_chains=num_chains, scheduler=scheduler,
                max_chains=max_chains,
            )
        ]
        self.failed: list[int] = []

    @property
    def survivors(self) -> list[int]:
        return [d for c in self.chains for d in c]

    def reform(self, node: FailureSpec) -> bool:
        """Re-form around the dead member(s) ``node`` — one node id or
        a set of concurrently dead members; True when handled.

        Only the sub-chains containing dead members change; every other
        sub-chain keeps its schedule verbatim. The *head* dying is total
        loss and raises :class:`~repro_torch.core.simulator.SourceFailedError`.
        Unknown nodes (already failed or never a member) return False
        without touching the plan.
        """
        dead = set(normalize_failed(node))
        if self.head in dead:
            raise SourceFailedError(
                f"node {self.head} is the plan head: total loss, "
                "re-forming cannot recover the source"
            )
        live = {d for c in self.chains for d in c}
        if dead - live:  # unknown/already-failed: leave the plan alone
            return False
        reformed: list[list[int]] = []
        for chain in self.chains:
            chain_dead = [d for d in chain if d in dead]
            if not chain_dead:
                reformed.append(chain)
                continue
            new = reform_chain(
                self.topo, chain, chain_dead, self.head,
                scheduler=self.scheduler,
            )
            if new:
                reformed.append(new)
        self.chains = reformed
        self.failed.extend(sorted(dead))
        return True

    def broadcast(self, x: torch.Tensor, *, num_frames: int = 1, group=None) -> torch.Tensor:
        """The (possibly degraded) multi-chain broadcast of row
        ``head`` of the stacked view ``x`` (``(L, n, ...)``) over the
        current survivor schedule; with a ``group``, of the head rank's
        payload, ``x`` being this rank's (``core.chainwrite``)."""
        if not self.chains:
            # every destination failed: only the head keeps its payload
            if group is not None:
                return x.clone() if cwd.group_rank(group) == self.head else torch.zeros_like(x)
            out = torch.zeros_like(x)
            out[self.head] = x[self.head]
            return out
        return cw.multi_chain_broadcast(x, self.head, self.chains, num_frames=num_frames,
                                        group=group)


def ring_order_for_axis(axis_size: int, scheduler: str = "tsp") -> tuple[int, ...]:
    """Chain order for a DP ring: the axis's devices scheduled as a 1-D
    NoC (linear neighbours), 1 hop per destination."""
    if axis_size <= 2 or scheduler == "naive":
        return tuple(range(axis_size))
    topo = MeshTopology(axis_size, 1)
    order = SCHEDULERS[scheduler](topo, list(range(1, axis_size)), source=0)
    return (0, *order)


def sub_ring_orders(
    axis_size: int, num_chains: int, scheduler: str = "tsp"
) -> list[tuple[int, ...]]:
    """Split the scheduled DP ring into ``num_chains`` contiguous
    sub-rings for ``multi_chain_all_reduce``."""
    if axis_size % num_chains:
        raise ValueError(
            f"num_chains={num_chains} must divide the DP group size {axis_size}"
        )
    ring = ring_order_for_axis(axis_size, scheduler)
    size = axis_size // num_chains
    return [tuple(ring[i * size : (i + 1) * size]) for i in range(num_chains)]


def _axis_orders(size: int, num_chains: int, scheduler: str) -> list[tuple[int, ...]]:
    """The K sub-ring partition of an axis of ``size`` (K=1 -> the
    single snake ring)."""
    if num_chains <= 1 or size <= num_chains:
        return [ring_order_for_axis(size, scheduler)]
    return sub_ring_orders(size, num_chains, scheduler)


def torrent_all_to_all(
    x: torch.Tensor, *, num_chains: int = 1, scheduler: str = "tsp",
    wire_dtype: str | None = None, group=None,
) -> torch.Tensor:
    """Scheduled-ring all-to-all over the rows of ``x`` (``(L, L,
    ...)``: ``x[s, d]`` goes to device ``d``); returns ``out[d, s]``.
    With a ``group``, ``x`` is this rank's ``(L, ...)`` chunk train and
    the result its ``(L, ...)`` received chunks (``core.chainwrite``)."""
    orders = _axis_orders(x.shape[0], num_chains, scheduler)
    if len(orders) == 1:
        return cw.chain_all_to_all(x, orders[0], wire_dtype=wire_dtype, group=group)
    return cw.multi_chain_all_to_all(x, orders, wire_dtype=wire_dtype, group=group)


def torrent_reduce_scatter(
    x: torch.Tensor, *, num_chains: int = 1, scheduler: str = "tsp"
) -> torch.Tensor:
    """Scheduled-ring reduce-scatter over the rows of ``x`` (``(L, L,
    ...)``); row ``d`` of the result is the reduced chunk ``d``."""
    orders = _axis_orders(x.shape[0], num_chains, scheduler)
    if len(orders) == 1:
        return cw.chain_reduce_scatter(x, orders[0])
    return cw.multi_chain_reduce_scatter(x, orders)


def torrent_all_gather(
    x: torch.Tensor, *, num_chains: int = 1, scheduler: str = "tsp",
    tiled: bool = False,
) -> torch.Tensor:
    """Scheduled-ring all-gather over the rows of ``x`` (device-id
    indexed stack, or concatenation with ``tiled=True``)."""
    orders = _axis_orders(x.shape[0], num_chains, scheduler)
    if len(orders) == 1:
        return cw.chain_all_gather(x, orders[0], tiled=tiled)
    return cw.multi_chain_all_gather(x, orders, tiled=tiled)


def _ring_topology(axis_size: int, topology) -> MeshTopology:
    """The advisory topology knob for one DP ring: ``None`` -> the
    uniform 1-D ring; a spec string -> ``parse_topology_spec``; a
    topology object passes through; a spec that does not fit the axis
    degrades to the uniform ring."""
    if topology is None:
        return MeshTopology(axis_size, 1)
    if isinstance(topology, MeshTopology):
        topo = topology
    else:
        try:
            topo = parse_topology_spec(str(topology), num_nodes=axis_size)
        except ValueError:
            return MeshTopology(axis_size, 1)
    if topo.num_nodes != axis_size:
        return MeshTopology(axis_size, 1)
    return topo


@functools.lru_cache(maxsize=None)
def auto_ring_chains(
    axis_size: int,
    size_bytes: int,
    scheduler: str = "tsp",
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    max_chains: int = 4,
    topo: MeshTopology | None = None,
) -> tuple[int, tuple[tuple[int, ...], ...]]:
    """Model-driven (K, sub_rings) for one DP reduction of
    ``size_bytes`` over ``axis_size`` devices — the ``num_chains=
    "auto"`` resolver (``core.simulator.choose_num_chains``)."""
    if axis_size <= 2:
        return 1, (tuple(range(axis_size)),)
    if topo is None:
        topo = MeshTopology(axis_size, 1)
    elif topo.num_nodes != axis_size:
        raise ValueError(
            f"topology has {topo.num_nodes} nodes for a ring of {axis_size}"
        )
    k, rings = sim.choose_num_chains(
        topo, 0, list(range(1, axis_size)), int(size_bytes),
        scheduler=scheduler, max_chains=max_chains,
        collective="all_reduce", algo=algo, wire_dtype=wire_dtype,
    )
    return k, tuple(tuple(r) for r in rings)


# ---------------------------------------------------------------------------
# Bucket assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One reduction bucket: its leaf indices (descending = reverse-
    topological dispatch order), their common dtype name, and their
    total unpadded bytes."""

    indices: tuple[int, ...]
    dtype: str
    num_bytes: int


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def assign_buckets(leaves_: Sequence, bucket_bytes: int) -> tuple[GradBucket, ...]:
    """Partition gradient leaves (anything with ``.shape`` and a torch
    ``.dtype``) into dtype-grouped, size-targeted buckets in REVERSE
    leaf order; a bucket exceeds ``bucket_bytes`` only when it holds a
    single oversized leaf."""
    target = int(bucket_bytes)
    if target <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets: list[GradBucket] = []
    idxs: list[int] = []
    cur_dtype = ""
    cur_bytes = 0

    def close() -> None:
        nonlocal idxs, cur_dtype, cur_bytes
        if idxs:
            buckets.append(GradBucket(tuple(idxs), cur_dtype, cur_bytes))
        idxs, cur_dtype, cur_bytes = [], "", 0

    for i in reversed(range(len(leaves_))):
        name = _dtype_name(leaves_[i].dtype)
        nbytes = math.prod(leaves_[i].shape) * _itemsize(leaves_[i].dtype)
        if idxs and (name != cur_dtype or cur_bytes + nbytes > target):
            close()
        idxs.append(i)
        cur_dtype = name
        cur_bytes += nbytes
    close()
    return tuple(buckets)


def all_reduce_shards(axis_size: int, num_chains: int, algo: str) -> int:
    """Chunk-address shard count of the planned all-reduce schedule,
    read off the plan itself (``addr_shards`` depends only on the (L,
    K, algo) shape)."""
    L, k = int(axis_size), max(1, int(num_chains))
    size = L // k
    orders = tuple(tuple(range(i * size, (i + 1) * size)) for i in range(k))
    return prg.plan_all_reduce(L, orders, algo=algo).addr_shards


def bucket_shard_layout(
    num_elems: Sequence[int], shards: int
) -> tuple[tuple[int, ...], int]:
    """Chunk-aligned bucket layout: leaf i occupies ``shards`` rows of
    ``ceil(n_i / shards)`` elements (zero-padded), concatenated along
    the row axis. Returns ``(widths, shards * sum(widths))``."""
    widths = tuple(-(-int(n) // int(shards)) for n in num_elems)
    return widths, int(shards) * sum(widths)


def resolve_ring_chains(
    axis_size: int,
    nbytes: int,
    *,
    num_chains: int | str = 1,
    scheduler: str = "tsp",
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    max_chains: int = 4,
    topology=None,
) -> tuple[int, tuple[tuple[int, ...], ...]]:
    """(K, sub_rings) for one DP reduction of ``nbytes`` per rank."""
    if num_chains == "auto":
        k, rings = auto_ring_chains(
            axis_size, nbytes, scheduler, algo, wire_dtype, max_chains,
            _ring_topology(axis_size, topology),
        )
        if k > 1:
            return k, rings
    elif isinstance(num_chains, int) and num_chains > 1 and axis_size > num_chains:
        return num_chains, tuple(sub_ring_orders(axis_size, num_chains, scheduler))
    return 1, (ring_order_for_axis(axis_size, scheduler),)


def ef_residual_init(params: PyTree, dp_size: int) -> PyTree:
    """Zero error-feedback state: one f32 ``(dp_size, *shape)`` residual
    per leaf, on each leaf's device (row ``r`` is rank ``r``'s)."""
    return map_tree(
        lambda p: torch.zeros((int(dp_size),) + tuple(p.shape), dtype=torch.float32,
                              device=p.device),
        params,
    )


def ef_residual_specs(mesh, params: PyTree) -> PyTree:
    """Partition specs of :func:`ef_residual_init` state: dim 0 over the
    DP axes of ``mesh`` (each rank owns its residual row)."""
    dp = dp_axes(mesh.axis_names)
    return map_tree(lambda _: P(dp), params)


def _mesh_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def split_batch(batch: dict, dp: int, r: int, batch_specs: dict | None = None) -> dict:
    """Rank ``r``'s rows of every batch leaf: its ``r``-th of ``dp``
    equal slices along the leaf's batch axis, which its spec in
    ``batch_specs`` (``parallel.sharding.batch_pspecs``, sanitized to a
    mesh or not) splits over the batch axes
    (``parallel.sharding.batch_axis``); axis 0 for a leaf it does not
    name. M-RoPE ``positions`` (3, B, S) are split along axis 1, so
    each rank keeps all three streams of its rows."""
    def take(x, axis):
        if x.shape[axis] % dp:
            raise ValueError(f"batch dim {x.shape[axis]} not divisible by {dp} DP ranks")
        n = x.shape[axis] // dp
        return x.narrow(axis, r * n, n)

    specs = batch_specs or {}
    return {k: take(x, batch_axis(specs[k]) if k in specs else 0) for k, x in batch.items()}


def _same_device(tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return devs.pop()


def _check_knobs(num_chains, algo, wire_dtype, error_feedback, bucket_bytes):
    if algo not in cw.ALL_REDUCE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}; expected {cw.ALL_REDUCE_ALGOS}")
    if num_chains != "auto" and not isinstance(num_chains, int):
        raise ValueError(f'num_chains must be an int or "auto", got {num_chains!r}')
    wire_dtype = prg.normalize_wire_dtype(wire_dtype)
    if error_feedback and wire_dtype is None:
        raise ValueError(
            "error_feedback=True requires a lossy wire_dtype "
            '(e.g. wire_dtype="int8"): with an exact wire there is no '
            "quantization residual to feed back"
        )
    if bucket_bytes is not None and int(bucket_bytes) <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    return wire_dtype


def dp_size_of(mesh) -> int:
    """The number of data-parallel ranks of ``mesh``: the product of its
    DP axes, whatever its ``model`` size (raises for a mesh without DP
    axes)."""
    dp = dp_axes(mesh.axis_names)
    if not dp:
        raise ValueError(f"mesh {mesh.axis_names} has no data-parallel axis")
    return _mesh_size(mesh, dp)


def stack_rank_grads(
    grad_fn: Callable[..., tuple[PyTree, PyTree]],
    params: PyTree,
    batch: PyTree,
    dp_size: int,
    *,
    out: list[torch.Tensor] | None = None,
    spans=None,
    batch_specs: dict | None = None,
) -> tuple[list[torch.Tensor], PyTree]:
    """Run ``grad_fn`` once per DP rank on its rows of ``batch`` (split
    along ``batch_specs``' axes, see :func:`split_batch`) and write rank
    ``r``'s grads into row ``r`` of one ``(dp_size, *shape)`` buffer per
    leaf (``out``, reused when its shapes match, else allocated).
    Returns (stacked leaves in tree order, metrics averaged over
    ranks)."""
    metrics_sum = None
    device = leaves(params)[0].device
    for r in range(dp_size):
        with maybe_span(spans, "fwd_bwd", device):
            grads, metrics = grad_fn(params, split_batch(batch, dp_size, r, batch_specs))
        g_leaves = leaves(grads)
        _same_device(g_leaves)
        if out is None or [(tuple(s.shape), s.dtype, s.device) for s in out] != [
            ((dp_size,) + tuple(g.shape), g.dtype, g.device) for g in g_leaves
        ]:
            out = [g.new_empty((dp_size,) + tuple(g.shape)) for g in g_leaves]
        for s, g in zip(out, g_leaves):
            s[r].copy_(g)
        del grads, g_leaves
        metrics_sum = metrics if metrics_sum is None else map_tree(
            lambda a, b: a + b, metrics_sum, metrics)
    return out, map_tree(lambda m: m / dp_size, metrics_sum)


def make_stacked_reduce(
    mesh,
    *,
    scheduler: str = "tsp",
    hierarchical: bool = True,
    num_chains: int | str = 1,
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    error_feedback: bool = False,
    bucket_bytes: int | None = None,
    topology=None,
) -> Callable[..., list[torch.Tensor]]:
    """``reduce(stacked, residual=None) -> grads``: the DP reduction of
    :func:`torrent_grad_reduce` over stacked per-rank leaves
    (``(dp, *shape)`` each, in tree order), returning one reduced leaf
    per input (rank 0's row divided by the DP size). On a
    :class:`~repro_torch.launch.mesh.ProcessMesh` each leaf is this
    rank's ``(1, *shape)`` row, reduced over the mesh's process groups,
    and the result is this rank's, written into the row's buffer (the
    rank's grads are consumed). With ``error_feedback`` pass the
    residual leaves (of the same rows): the new residual is written into
    them, and ``stacked`` is used as scratch."""
    wire_dtype = _check_knobs(num_chains, algo, wire_dtype, error_feedback, bucket_bytes)
    dp = dp_axes(mesh.axis_names)
    dp_size = dp_size_of(mesh)
    process = mesh.group(dp) is not None

    if process:
        # a stage is (the process group, its size): within each pod,
        # then across pods; or one group over every DP axis
        if hierarchical and len(dp) == 2:
            stages = [(mesh.group(dp[1]), mesh.shape[dp[1]]),
                      (mesh.group(dp[0]), mesh.shape[dp[0]])]
        else:
            stages = [(mesh.group(dp), dp_size)]
    elif hierarchical and len(dp) == 2:
        # within each pod (rows p·D + d over d), then across pods (over p)
        P, D = mesh.shape[dp[0]], mesh.shape[dp[1]]
        stages = [([[p * D + d for d in range(D)] for p in range(P)], D),
                  ([[p * D + d for p in range(P)] for d in range(D)], P)]
    else:
        stages = [([list(range(dp_size))], dp_size)]

    def _rings_for(size: int, nbytes: int):
        return resolve_ring_chains(
            size, nbytes, num_chains=num_chains, scheduler=scheduler,
            algo=algo, wire_dtype=wire_dtype, topology=topology,
        )

    def _ar(x, k, rings, group=None):
        if k > 1:
            return cw.multi_chain_all_reduce(x, rings, algo=algo, wire_dtype=wire_dtype,
                                             group=group)
        return cw.chain_all_reduce(x, rings[0], wire_dtype=wire_dtype, group=group)

    def _ar_stage(x, groups, k, rings):
        """All-reduce ``x`` (``(dp, n)``) within each row group, or this
        rank's ``(1, n)`` over its process group."""
        if process:
            return _ar(x[0], k, rings, groups)[None]
        if len(groups) == 1:
            return _ar(x, k, rings)
        out = torch.empty_like(x)
        for g in groups:
            idx = torch.tensor(g, dtype=torch.int64, device=x.device)
            out.index_copy_(0, idx, _ar(x.index_select(0, idx), k, rings))
        return out

    def _divide(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        # a tensor divisor keeps the divide a true division on CUDA too
        div = torch.tensor(float(dp_size), dtype=flat.dtype, device=flat.device)
        if process and flat.dtype == like.dtype:
            # the rank's row is its own grad: the mean goes into its buffer,
            # so the step never holds the grads twice
            return torch.div(flat[0].reshape(like.shape[1:]), div, out=like[0])
        return (flat[0] / div).reshape(like.shape[1:]).to(like.dtype)

    def _ef(flat: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """Fold the rank residuals into ``flat`` (in place when f32) and
        write the new residual into ``r``; returns the f32 payload."""
        rf = r.reshape(flat.shape)
        flat = flat.add_(rf) if flat.dtype == torch.float32 else flat.float() + rf
        q, s = quantize_rows(flat)
        torch.sub(flat, dequantize_rows(q, s), out=rf)
        return flat

    def reduce_one(g: torch.Tensor, r: torch.Tensor | None = None) -> torch.Tensor:
        flat = g.reshape(g.shape[0], -1)
        if r is not None:
            flat = _ef(flat, r)
        for groups, size in stages:
            k, rings = _rings_for(size, flat[0].numel() * flat.element_size())
            flat = _ar_stage(flat, groups, k, rings)
        return _divide(flat, g)

    def _reduce_bucket_flats(flats: list[torch.Tensor]) -> list[torch.Tensor]:
        """One bucket = ONE chain all-reduce over the chunk-aligned
        concatenation of its leaves' ``(dp, n_i)`` payloads."""
        nbytes = sum(f[0].numel() * f.element_size() for f in flats)
        plans = [(groups,) + _rings_for(size, nbytes) for groups, size in stages]
        shards = all_reduce_shards(stages[0][1], plans[0][1], algo)
        widths, _ = bucket_shard_layout([f.shape[1] for f in flats], shards)
        L = flats[0].shape[0]
        if len(flats) == 1 and flats[0].shape[1] == shards * widths[0]:
            payload = flats[0]  # one leaf that needs no padding: no copy
        else:
            mat = flats[0].new_zeros((L, shards, sum(widths)))
            off = 0
            for f, m in zip(flats, widths):
                full, rem = divmod(f.shape[1], m)
                dst = mat[:, :, off : off + m]
                if full:
                    dst[:, :full] = f[:, : full * m].reshape(L, full, m)
                if rem:
                    dst[:, full, :rem] = f[:, full * m :]
                off += m
            payload = mat.reshape(L, -1)
        for groups, k, rings in plans:
            payload = _ar_stage(payload, groups, k, rings)
        mat = payload.reshape(L, shards, -1)
        outs, off = [], 0
        for f, m in zip(flats, widths):
            outs.append(mat[:, :, off : off + m].reshape(L, -1)[:, : f.shape[1]])
            off += m
        return outs

    def reduce(stacked: list[torch.Tensor], residual: list[torch.Tensor] | None = None):
        if error_feedback and residual is None:
            raise ValueError("error_feedback=True: pass the residual leaves")
        res = residual if error_feedback else [None] * len(stacked)
        _same_device(list(stacked) + list(residual or []))
        if bucket_bytes is None:
            return [reduce_one(g, r) for g, r in zip(stacked, res)]
        out = [None] * len(stacked)
        for b in assign_buckets([s[0] for s in stacked], bucket_bytes):
            flats = []
            for i in b.indices:
                flat = stacked[i].reshape(stacked[i].shape[0], -1)
                if res[i] is not None:
                    flat = _ef(flat, res[i])
                flats.append(flat)
            for i, rf in zip(b.indices, _reduce_bucket_flats(flats)):
                out[i] = _divide(rf, stacked[i])
        return out

    return reduce


def torrent_grad_reduce(
    grad_fn: Callable[..., tuple[PyTree, PyTree]],
    mesh,
    batch_specs: dict | None = None,
    *,
    scheduler: str = "tsp",
    hierarchical: bool = True,
    num_chains: int | str = 1,
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    error_feedback: bool = False,
    bucket_bytes: int | None = None,
    topology=None,
    spans=None,
) -> Callable[..., tuple[PyTree, PyTree]]:
    """Wrap ``grad_fn(params, batch) -> (grads, metrics)`` (grads of the
    rank's local mean loss) so grads come back chain-all-reduced over
    the DP axes of ``mesh`` and divided by the DP size.

    ``wrapped(params, batch)`` splits every batch leaf along its batch
    axis (``batch_specs``, as in :func:`split_batch`; dim 0 when None)
    into the ranks' rows, runs ``grad_fn`` per rank into one preallocated
    stacked buffer per leaf (:func:`stack_rank_grads`), reduces it
    (:func:`make_stacked_reduce`) and returns ``(grads, metrics)``: the
    reduced grads (rank 0's row, as the JAX package's replicated output)
    and the metrics averaged over ranks. ``error_feedback=True`` (needs
    ``wire_dtype="int8"``) changes the signature to ``wrapped(params,
    batch, residual) -> (grads, metrics, new_residual)`` with residuals
    from :func:`ef_residual_init`; the new residual is written into
    ``residual``'s buffers (the step owns its state, as the JAX step
    donates it) and returned.

    ``bucket_bytes`` reduces each bucket of :func:`assign_buckets` as
    ONE chunk-aligned chain all-reduce, in reverse leaf order; at the
    exact wire the result is bit-identical to the per-leaf reduce.
    ``spans`` (a :class:`~repro_torch.runtime.spans.Spans`) records a
    ``fwd_bwd`` span per rank and a ``reduce`` span.

    On a :class:`~repro_torch.launch.mesh.ProcessMesh` (JAX's
    ``shard_map`` form) ``batch`` is this rank's own rows, ``grad_fn``
    runs once on them, the grads come back reduced over the mesh's
    process groups (this rank's result) and the metrics averaged over the
    ranks with one all-reduce; the residual leaves are this rank's
    ``(1, *shape)`` rows (``ef_residual_init(params, 1)``), and the
    ``fwd_bwd`` and ``reduce`` spans are this process's. With a live
    ``model`` axis the grads (and residuals) are this rank's TP shards,
    reduced over its DP group only (a group of one where the DP axes
    have size 1), so a rank sends ``program_wire_bytes`` of its shard
    sizes."""
    dp_size = dp_size_of(mesh)

    group = mesh.group(dp_axes(mesh.axis_names))
    if group is not None:
        def per_rank(params, batch, out):
            with maybe_span(spans, "fwd_bwd", leaves(params)[0].device):
                grads, metrics = grad_fn(params, batch)
            g_leaves = leaves(grads)
            _same_device(g_leaves)
            return [g.unsqueeze(0) for g in g_leaves], _rank_mean(metrics, group, dp_size)
    else:
        def per_rank(params, batch, out):
            return stack_rank_grads(grad_fn, params, batch, dp_size, out=out, spans=spans,
                                    batch_specs=batch_specs)

    return _reduced(per_rank, mesh, scheduler=scheduler, hierarchical=hierarchical,
                    num_chains=num_chains, algo=algo, wire_dtype=wire_dtype,
                    error_feedback=error_feedback, bucket_bytes=bucket_bytes,
                    topology=topology, spans=spans, reuse=group is None)


def torrent_joint_grad_reduce(
    joint_grad_fn: Callable[..., tuple[list[torch.Tensor], PyTree]],
    mesh,
    *,
    scheduler: str = "tsp",
    hierarchical: bool = True,
    num_chains: int | str = 1,
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    error_feedback: bool = False,
    bucket_bytes: int | None = None,
    topology=None,
    spans=None,
) -> Callable[..., tuple[PyTree, PyTree]]:
    """:func:`torrent_grad_reduce` for a grad function that runs every
    DP rank at once: ``joint_grad_fn(params, batch, out) -> (stacked,
    metrics)`` writes rank ``r``'s grads into row ``r`` of one ``(dp,
    *shape)`` leaf per param (``out``, reused when its shapes match, else
    allocated; tree order) and returns the metrics averaged over ranks —
    the train step's expert-parallel forward, whose MoE layers exchange
    tokens between the ranks. Its call is recorded as one ``fwd_bwd``
    span; the reduction, its knobs, the signatures and the ``reduce``
    span are :func:`torrent_grad_reduce`'s."""
    def joint(params, batch, out):
        with maybe_span(spans, "fwd_bwd", leaves(params)[0].device):
            stacked, metrics = joint_grad_fn(params, batch, out)
        _same_device(stacked)
        return stacked, metrics

    return _reduced(joint, mesh, scheduler=scheduler, hierarchical=hierarchical,
                    num_chains=num_chains, algo=algo, wire_dtype=wire_dtype,
                    error_feedback=error_feedback, bucket_bytes=bucket_bytes,
                    topology=topology, spans=spans)


def _rank_mean(metrics: PyTree, group, dp_size: int) -> PyTree:
    """Every rank's metrics averaged over ``group``: one all-reduce of
    the stacked leaves (the JAX package's ``psum / dp_size``)."""
    flat = leaves(metrics)
    total = cwd.all_reduce_sum(torch.stack([m.to(torch.float32) for m in flat]), group)
    return unflatten(metrics, [(t / dp_size).to(m.dtype) for t, m in zip(total, flat)])


def _reduced(stacked_fn, mesh, *, spans, error_feedback, reuse=True, **reduce_kw):
    """Wrap ``stacked_fn(params, batch, out) -> (stacked, metrics)`` so
    its stacked per-rank grads come back reduced by
    :func:`make_stacked_reduce`; with ``reuse`` the stacked buffers are
    kept and handed back as ``out`` on the next call (the process form's
    rows are views of the grads it just made, which would only be held
    through the optimizer: a second copy of the grads)."""
    reduce = make_stacked_reduce(mesh, error_feedback=error_feedback, **reduce_kw)
    buf: dict[str, list[torch.Tensor] | None] = {"stacked": None}

    def _grads(params, batch, residual=None):
        stacked, metrics = stacked_fn(params, batch, buf["stacked"])
        if reuse:
            buf["stacked"] = stacked
        with maybe_span(spans, "reduce", stacked[0].device):
            out = reduce(stacked, None if residual is None else leaves(residual))
        del stacked
        return unflatten(params, out), metrics

    def wrapped(params, batch):
        return _grads(params, batch)

    def wrapped_ef(params, batch, residual):
        grads, metrics = _grads(params, batch, residual)
        return grads, metrics, residual

    return wrapped_ef if error_feedback else wrapped


__all__ = [
    "GradBucket",
    "MultiChainPlan",
    "all_reduce_shards",
    "assign_buckets",
    "auto_ring_chains",
    "bucket_shard_layout",
    "dp_size_of",
    "ef_residual_init",
    "ef_residual_specs",
    "make_stacked_reduce",
    "resolve_ring_chains",
    "ring_order_for_axis",
    "split_batch",
    "stack_rank_grads",
    "sub_ring_orders",
    "torrent_all_gather",
    "torrent_all_to_all",
    "torrent_grad_reduce",
    "torrent_joint_grad_reduce",
    "torrent_reduce_scatter",
]
