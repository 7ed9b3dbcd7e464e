"""Fine-grained MoE (DeepSeek-MoE style: shared + routed experts, top-k)
— the port of ``repro.models.moe``.

Dispatch is sort-based with a static capacity, as in the JAX package:

1. router top-k (f32) → flat assignment list (T·k,),
2. position-in-expert via a stable argsort + searchsorted,
3. scatter into the (E, C, d) expert buffer; assignments past the
   capacity are dropped,
4. batched expert SwiGLU over the expert dim,
5. gather-combine weighted by the router probs (dropped → 0).

JAX writes step 3 as ``.at[e, pos].set(v, mode="drop")`` and reads
step 5 as ``.at[e, pos].get(mode="fill")``. Here the write is an
``index_put`` into the flat buffer plus one spare row that takes every
out-of-bounds assignment and is cut off (:func:`_put`), and the read a
clamped gather zeroed where out of bounds (:func:`_take`).
The drop set is JAX's, and no ``index_add_`` appears (the buffers are
written, never accumulated). The flat and rowwise paths read nothing
back to the host, so a call never waits for the card (``chip_smoke.py``
runs them under CUDA's sync debug mode); the expert counts of the aux
loss are an integer ``scatter_add_`` on the card, exact in any order.

:func:`moe_apply_ep` is the Torrent expert-parallel formulation on the
stacked view (row ``r`` of ``x`` is virtual device ``r``'s token
shard): the dispatch and the return are scheduled chain all-to-alls
(``parallel.collectives.torrent_all_to_all``). ``cfg.moe_ep_dispatch``
routes to it when a virtual DP group is named with
``parallel.hints.set_mesh`` and divides the experts and the batch. With
a ``group`` it is one rank of the process form, JAX's ``shard_map``
formulation: ``x`` is this rank's own tokens, the exchanges run over
the group as autograd functions whose backward is the transposed
exchange, and the aux statistics are averaged over the ranks with an
all-reduce (JAX's ``pmean``); ``moe_ep_dispatch`` takes it when the mesh
named has a process group over its DP axes (``mesh.group``) and that
group divides the experts.
Its params are one tree that every row reads, or a list of one tree
per row: then row ``r`` routes with and runs the shared experts of its
own tree, and the experts it owns are read from its own tree — the
train step's per-rank params, so one backward gives each rank the
grads JAX's ``shard_map`` ranks get.

The aux load-balancing loss (switch-style E·Σ f_i·P_i) is returned to
the caller and folded into the training loss.

Tensor parallelism (the flat and rowwise paths on a mesh whose
``model`` axis is live, ``parallel.hints.tp_group``): the experts are
split over ``model`` as ``param_pspecs`` places them (``E/tp`` a rank;
an ``E`` the TP size does not divide stays whole), and the shared
experts' SwiGLU by columns. The tokens are replicated over ``model``,
so every rank routes all of them, with TP = 1's capacity drops and aux
loss, and no all-to-all is needed: a rank fills and runs only its own
experts' slice of the buffer, reads zeros for the other ranks'
assignments, and one f32 ``reduce_from_tp`` sums the ranks' combines
with their shared-expert partial sums. ``copy_to_tp`` sits on the
router weights ``top_p`` and on the split branches' input, so the
replicated router and the layer's input get their whole grads.
``moe_ep_dispatch`` (EP over the DP axes) composes with that split: the
chain all-to-alls run over each model column's DP group, and a rank
runs the experts it owns over ``data`` that lie in its ``model`` block
(:func:`moe_apply_ep`).

On a ``ProcessMesh`` whose DP axes are live, a rank holds its own rows.
The flat dispatch then takes the capacity, the positions and the aux
loss of the global batch where JAX's counterpart is a GSPMD function of
it (``hints.global_dp_group``: prefill, decode, the ``collectives="xla"``
train step), the ranks exchanging their per-expert counts, and each
rank's own inside JAX's ``shard_map`` (``hints.manual_axes``: the
Torrent train step). The rowwise dispatch and ``moe_apply_ep`` keep
their per-row and per-pair capacities.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel import hints
from repro_torch.parallel.tp import copy_to_tp, gather_from_tp, reduce_from_tp

from .config import ModelConfig
from .layers import cast, matmul, normal, swiglu, swiglu_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": normal(gen, (d, E), d ** -0.5, device),
        "wg": normal(gen, (E, d, f), d ** -0.5, device),
        "wu": normal(gen, (E, d, f), d ** -0.5, device),
        "wd": normal(gen, (E, f, d), f ** -0.5, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.num_shared_experts * f, device)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.moe_top_k / cfg.num_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _bucket_capacity(assignments: int, buckets: int, factor: float) -> int:
    """Static per-bucket capacity for ``assignments`` spread over
    ``buckets`` (same rounding policy as :func:`capacity`)."""
    c = int(math.ceil(assignments / buckets * factor))
    return max(8, -(-c // 8) * 8)


def moe_apply(params: dict | list[dict], x: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Per-row params (a list, one tree
    per rank of the expert-parallel group) take ``moe_apply_ep``."""
    if cfg.moe_ep_dispatch:
        return _moe_apply_ep_auto(params, x, cfg)
    if cfg.moe_row_dispatch:
        return moe_apply_rowwise(params, x, cfg)
    return _moe_apply_flat(params, x, cfg)


# ---------------------------------------------------------------------------
# Routing, positions, drop-writes and fill-reads
# ---------------------------------------------------------------------------


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """(probs, renormalised top-k probs, top-k experts), in f32; top-k
    in descending order, as ``jax.lax.top_k``."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e  # deepseek renormalizes


def _counts(keys: torch.Tensor, groups: int) -> torch.Tensor:
    """How many of ``keys`` fall in each of ``groups`` (exact, f32).
    An integer ``scatter_add_``: ``bincount`` reads its input's range
    back to the host on CUDA."""
    keys = keys.reshape(-1)
    counts = torch.zeros(groups, dtype=torch.int64, device=keys.device)
    return counts.scatter_add_(0, keys, torch.ones_like(keys)).float()


def _aux(cfg: ModelConfig, P_i: torch.Tensor, f_i: torch.Tensor) -> torch.Tensor:
    return cfg.router_aux_loss_coef * cfg.num_experts * torch.sum(f_i * P_i)


def _positions(key: torch.Tensor, groups: int) -> torch.Tensor:
    """Each entry's position among the entries with its key, in order
    (keys in ``[0, groups)``): JAX's stable argsort + searchsorted."""
    n = key.numel()
    sort_idx = torch.argsort(key, stable=True)
    sorted_k = key[sort_idx]
    starts = torch.searchsorted(
        sorted_k, torch.arange(groups, dtype=key.dtype, device=key.device), side="left")
    pos_sorted = torch.arange(n, device=key.device) - starts[sorted_k]
    return torch.empty_like(pos_sorted).scatter_(0, sort_idx, pos_sorted)


def _linear(dims, index: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major linear index of ``index`` into ``dims`` (each index
    clamped into its dim), and where any index is at or past its dim's
    size (never negative here)."""
    lin, out = None, None
    for i, n in zip(index, dims):
        c = i.clamp(max=n - 1)
        lin = c if lin is None else lin * n + c
        out = i >= n if out is None else out | (i >= n)
    return lin, out


def _put(dims: tuple[int, ...], index: tuple, vals: torch.Tensor, fill=0) -> torch.Tensor:
    """``full(dims + trailing, fill).at[index].set(vals, mode="drop")``:
    an assignment with an index out of bounds is dropped. The buffer is
    written flat with one spare row after its ``prod(dims)`` rows; every
    dropped assignment lands there, and it is cut off. The assignments
    in bounds are distinct, so the write is deterministic."""
    lin, out = _linear(dims, index)
    total = math.prod(dims)
    trailing = tuple(vals.shape[index[0].dim():])
    buf = vals.new_full((total + 1,) + trailing, fill)
    buf = buf.index_put((torch.where(out, total, lin),), vals)
    return buf[:total].view(tuple(dims) + trailing)


def _take(buf: torch.Tensor, index: tuple) -> torch.Tensor:
    """``buf.at[index].get(mode="fill", fill_value=0)``: an index out of
    bounds reads zeros."""
    dims = buf.shape[: len(index)]
    lin, out = _linear(dims, index)
    got = buf.reshape((-1,) + buf.shape[len(index):])[lin]
    return torch.where(out.reshape(out.shape + (1,) * (got.dim() - out.dim())),
                       got.new_zeros(()), got)


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor):
    """SwiGLU of every expert on its slots: ``buf`` (E, C, d) and
    weights (E, d, f) / (E, f, d), batched over the expert dim."""
    h = F.silu(matmul(buf, wg)) * matmul(buf, wu)
    return matmul(h, wd)


def _combine(gathered: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_k w·gathered in f32 over the top-k dim (-2): products of the
    operands as they are (exact for 16-bit ones), summed in f32."""
    return (gathered.float() * w.float()[..., None]).sum(-2)


def _with_shared(params, cfg: ModelConfig, xf: torch.Tensor, out: torch.Tensor):
    """``out`` plus the shared experts of ``xf``; with per-row params
    (a list), row ``r`` of ``xf`` runs through tree ``r``'s."""
    if cfg.num_shared_experts:
        if isinstance(params, list):
            shared = torch.stack([swiglu(p["shared"], xr) for p, xr in zip(params, xf)])
        else:
            shared = swiglu(params["shared"], xf)
        out = out + shared.float()
    return out


# ---------------------------------------------------------------------------
# Single-device paths
# ---------------------------------------------------------------------------


def _tp_groups(cfg: ModelConfig):
    """The active TP group over which the routed experts are split (the
    TP size divides ``num_experts``) and the one over which the shared
    experts' columns are (it divides them); ``None`` where a part stays
    whole, as ``param_pspecs`` leaves it."""
    shared = cfg.num_shared_experts * cfg.moe_d_ff
    return (hints.tp_split_group(cfg.num_experts),
            hints.tp_split_group(shared) if shared else None)


def _local_experts(flat_e: torch.Tensor, group, E: int) -> tuple[torch.Tensor, int]:
    """Each assignment's expert among this rank's ``E/tp`` (group rank
    ``r`` holds experts ``[r·E/tp, (r+1)·E/tp)``), and that count; an
    assignment to another rank's expert gets the count, out of bounds,
    so :func:`_put` drops it and :func:`_take` reads zeros. Without a
    group: the experts and ``E`` as they are."""
    if group is None:
        return flat_e, E
    n = E // dist.get_world_size(group)
    le = flat_e - dist.get_rank(group) * n
    return torch.where((le >= 0) & (le < n), le, n), n


def _tp_out(params, cfg: ModelConfig, xf: torch.Tensor, xs: torch.Tensor,
            routed: torch.Tensor, eg, sg) -> torch.Tensor:
    """The routed experts' f32 combine ``routed`` plus the shared
    experts (``xs``: the input of the split parts, through
    ``copy_to_tp``), reduced once over the TP group: the parts split
    over it (this rank's experts' share, its block of the shared
    experts' columns) are summed in f32 and all-reduced, then the parts
    that stay whole are added. Without a group, TP = 1's sum."""
    shared = None
    if cfg.num_shared_experts:
        shared = swiglu(params["shared"], xs if sg is not None else xf).float()
    group = eg if eg is not None else sg
    if group is None:
        return routed if shared is None else routed + shared
    parts = [(routed, eg), (shared, sg)]
    split = [t for t, g in parts if t is not None and g is not None]
    out = reduce_from_tp(split[0] if len(split) == 1 else split[0] + split[1], group)
    for t, g in parts:
        if t is not None and g is None:
            out = out + t
    return out


def _global_slots(probs, top_e, flat_e, pos, T: int, cfg: ModelConfig, group):
    """The capacity, positions and aux loss of the global batch, whose
    ``T``-token blocks the ranks of the DP ``group`` hold in group rank
    order (JAX's flattened token stream, token-major): every rank's
    per-expert assignment counts and router probability sums, gathered
    in one (2, E) f32 exchange (counts exact below 2**24). A rank's
    position of an assignment is its local one plus the counts of the
    lower ranks; an assignment at or past ``capacity(cfg, T · n)`` is
    dropped. The rank's buffer is indexed by the local position and
    holds ``min(C, T)`` slots an expert (a token reaches an expert at
    most once, so no kept local position reaches either), not C: the
    returned size, and a dropped assignment's position is that size (out
    of bounds). The backward of the gather sums the ranks' grads of the
    probability sums, so the mean of the ranks' grads is the global aux
    loss's."""
    E, k = cfg.num_experts, cfg.moe_top_k
    n, r = dist.get_world_size(group), dist.get_rank(group)
    stats = gather_from_tp(torch.stack([_counts(top_e, E), probs.sum(0)])[None], group, 0)
    total = stats.sum(0)
    C = capacity(cfg, T * n)
    slots = min(C, T)
    seen = stats[:r, 0].sum(0).long()[flat_e]  # the lower ranks' assignments to each expert
    pos = torch.where(pos + seen < C, pos, slots)
    return slots, pos, _aux(cfg, total[1] / (T * n), total[0] / (T * n * k))


def _moe_apply_flat(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The flat dispatch (module docstring). On a live TP group that
    splits the experts, every rank routes every token (the tokens are
    replicated over ``model``), so the capacity drops and the aux loss
    are TP = 1's; it runs only its own experts' slice of the ``(E, C,
    d)`` buffer, and the ranks' combines are summed once
    (:func:`_tp_out`). Where the active mesh's DP axes are live and not
    Manual (``hints.global_dp_group``: JAX's GSPMD function of the whole
    batch, as its prefill, decode and xla train step are), the capacity,
    the drops and the aux loss are the global batch's
    (:func:`_global_slots`); inside ``hints.manual_axes`` (JAX's
    ``shard_map`` rank, as the Torrent train step's) each rank's own."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, d)
    eg, sg = _tp_groups(cfg)

    probs, top_p, top_e = _route(xf, params["router"], k)
    flat_e = top_e.reshape(-1)  # (T*k,), token-major
    pos = _positions(flat_e, E)
    dg = hints.global_dp_group()
    if dg is None:
        C = capacity(cfg, T)
        aux = _aux(cfg, probs.mean(0), _counts(top_e, E) / (T * k))
    else:
        C, pos, aux = _global_slots(probs, top_e, flat_e, pos, T, cfg, dg)
    # the split branches' input: each rank's grad holds only its share
    xs = copy_to_tp(xf, eg if eg is not None else sg)
    le, E_loc = _local_experts(flat_e, eg, E)
    xe = xs if eg is not None else xf
    sel = xe[:, None].expand(T, k, d).reshape(T * k, d)  # the dispatch traffic
    buf = _put((E_loc, C), (le, pos), sel)
    out_buf = _experts(buf, params["wg"], params["wu"], params["wd"])
    gathered = _take(out_buf, (le, pos)).reshape(T, k, d)  # dropped, or not ours -> 0
    top_p = copy_to_tp(top_p, eg)
    # the bf16 wire keeps the combine operands in the activation dtype;
    # f32 only in the top-k accumulation
    w = top_p.to(gathered.dtype) if cfg.moe_bf16_wire else top_p
    out = _tp_out(params, cfg, xf, xs, _combine(gathered, w), eg, sg)
    return out.to(x.dtype).reshape(B, S, d), aux


def moe_apply_rowwise(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Row-wise (per-batch-row) dispatch: every position and capacity is
    row-local (C_row from S tokens), the combine runs on a bf16 wire.
    Same routing and aux loss as the flat path, and the same TP split
    (:func:`_moe_apply_flat`)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    C = capacity(cfg, S)
    xf = x.reshape(B * S, d)
    eg, sg = _tp_groups(cfg)

    probs, top_p, top_e = _route(xf, params["router"], k)
    aux = _aux(cfg, probs.mean(0), _counts(top_e, E) / (B * S * k))

    flat_e = top_e.reshape(B, S * k)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    pos = _positions((rows * E + flat_e).reshape(-1), B * E).reshape(B, S * k)
    xs = copy_to_tp(xf, eg if eg is not None else sg)
    le, E_loc = _local_experts(flat_e, eg, E)
    xe = (xs if eg is not None else xf).reshape(B, S, d)
    xk = xe[:, :, None].expand(B, S, k, d).reshape(B, S * k, d)
    # laid out (E, B, C, d), so the expert products batch over E alone
    # and no weight is broadcast over the rows
    buf = _put((E_loc, B, C), (le, rows, pos), xk)
    out_buf = _experts(buf.reshape(E_loc, B * C, d), params["wg"], params["wu"], params["wd"])
    gathered = _take(out_buf.reshape(E_loc, B, C, d), (le, rows, pos)).reshape(B, S, k, d)
    w = copy_to_tp(top_p, eg).reshape(B, S, k).to(x.dtype)
    out = _combine(gathered, w).reshape(B * S, d)
    out = _tp_out(params, cfg, xf, xs, out, eg, sg)
    return out.to(x.dtype).reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Torrent expert-parallel dispatch (chain all-to-all over the stacked view)
# ---------------------------------------------------------------------------


class _GroupAllToAll(torch.autograd.Function):
    """The process form's token exchange: ``torrent_all_to_all`` over a
    group. Its transpose (``out[d][s] = x[s][d]`` read backwards) is the
    same exchange of the cotangents."""

    @staticmethod
    def forward(ctx, x, group, num_chains, scheduler):
        from repro_torch.parallel.collectives import torrent_all_to_all

        ctx.args = (group, num_chains, scheduler)
        return torrent_all_to_all(x, num_chains=num_chains, scheduler=scheduler, group=group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.parallel.collectives import torrent_all_to_all

        group, num_chains, scheduler = ctx.args
        return (torrent_all_to_all(g.contiguous(), num_chains=num_chains, scheduler=scheduler,
                                   group=group), None, None, None)


class _GroupMean(torch.autograd.Function):
    """JAX's ``pmean`` over a group: the ranks' mean, whose transpose
    averages the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group, n):
        from repro_torch.core.chainwrite_dist import all_reduce_sum

        ctx.args = (group, n)
        return all_reduce_sum(x, group) / n

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.chainwrite_dist import all_reduce_sum

        group, n = ctx.args
        return all_reduce_sum(g, group) / n, None, None


def moe_apply_ep(
    params: dict | list[dict],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    num_chains: int = 1,
    scheduler: str = "tsp",
    wire_dtype: str | None = None,
    group=None,
    tp_groups: tuple = (None, None),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on the stacked view: ``x`` is ``(n, B_loc,
    S, d)``, row ``r`` virtual device ``r``'s local tokens, and the
    routed experts are partitioned contiguously over the ``n`` devices
    (device ``r`` owns experts ``[r·E/n, (r+1)·E/n)``) — JAX's
    ``moe_apply_ep`` under ``shard_map``, every device at once.

    Each row routes its own tokens into an ``(n, C_pair, d)`` send
    buffer (and the expert ids into ``send_e``); two chain all-to-alls
    (``num_chains > 1``: the K-ring schedule) take them to the experts'
    owners, which dispatch into their ``(E_loc, C_loc, d)`` buffers,
    run their expert block, and send the results back; the combine runs
    at the source with the router weights that never left. Capacity is
    enforced per (source, destination) pair and per local expert, both
    with ``cfg.capacity_factor`` headroom. ``wire_dtype="int8"`` ships
    the token payloads of both exchanges quantized per hop; ``send_e``
    always travels exact. The aux loss is the global one: the per-row
    ``f_i``/``P_i`` are averaged over the rows (JAX's ``pmean``).

    ``params`` is one tree for every row, or a list of ``n`` trees: row
    ``r`` then routes with tree ``r``'s router and shared experts, and
    its expert block (the experts row ``r`` owns) is tree ``r``'s — what
    each of JAX's ``shard_map`` ranks reads from its own copy of the
    params.

    With a ``group`` (``torch.distributed``; the process form) ``x`` is
    ``(1, B_loc, S, d)``, this rank's tokens, ``n`` is the group's size
    and ``params`` this rank's tree; the exchanges run over the group
    (their backward is the transposed exchange; no gradient crosses an
    int8 wire, as in the stacked executor) and the aux statistics are
    averaged over it.

    ``tp_groups`` (the process form under a live ``model`` axis:
    :func:`_tp_groups`' expert and shared-expert groups) composes EP
    over ``group`` (the DP axes) with the experts split over ``model``
    as ``param_pspecs`` places them. The tokens are replicated over
    ``model``, so every model column routes them alike and runs the
    same exchanges over its own DP group; ownership is JAX's (DP rank
    ``d`` owns experts ``[d·E/n, (d+1)·E/n)``, capacities per pair and
    per local expert as above). Rank ``(d, m)`` runs the owned experts
    that lie in its model block (``[m·E/tp, (m+1)·E/tp)``, the experts
    it holds) and returns zeros for the rest; the combine is summed over
    ``model`` with the shared experts' column blocks (:func:`_tp_out`),
    so each expert's output comes from the one column that ran it.
    ``copy_to_tp`` sits on the dispatched tokens and on the router
    weights, whose grads are each column's share. An expert's grads come
    from its owner row alone, and the DP reduce averages them, as at
    TP = 1. Where ``E/n`` and ``E/tp`` blocks do not nest, some ranks run
    no expert (E = 64 on ``(2, 2)``: ranks ``(0, 1)`` and ``(1, 0)``)."""
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.parallel.collectives import torrent_all_to_all

    R, B, S, d = x.shape
    n = R if group is None else cwd.group_size(group)
    E, k = cfg.num_experts, cfg.moe_top_k
    if E % n:
        raise ValueError(f"num_experts={E} not divisible by EP group size {n}")
    ranked = isinstance(params, list)
    if ranked and (group is not None or len(params) != n):
        raise ValueError(f"{len(params)} per-row param trees for {n} rows")
    if group is not None and R != 1:
        raise ValueError(f"the process form takes this rank's tokens as one row, got {R}")
    E_loc = E // n
    T = B * S
    dev = x.device
    xf = x.reshape(R, T, d)
    a2a = dict(num_chains=num_chains, scheduler=scheduler)
    ids = (torch.arange(n, device=dev) if group is None
           else torch.tensor([cwd.group_rank(group)], device=dev))  # each row's device

    def rank_mean(t):  # (R, ...) per-row statistics -> their mean over the devices
        return t.mean(0) if group is None else _GroupMean.apply(t[0], group, n)

    def exchange(t, wire=None):
        if group is None:
            return torrent_all_to_all(t, wire_dtype=wire, **a2a)
        if wire is not None or not t.is_floating_point():
            with torch.no_grad():
                return torrent_all_to_all(t[0], wire_dtype=wire, group=group, **a2a)[None]
        return _GroupAllToAll.apply(t[0], group, num_chains, scheduler)[None]

    eg, sg = tp_groups
    if (eg is not None or sg is not None) and group is None:
        raise ValueError("a model group needs the process form (group=)")
    # the split branches' input: each model column's grad holds its share
    xs = copy_to_tp(xf, eg if eg is not None else sg)

    # -- routing (f32, local tokens; global aux via row-averaged stats) -
    router = torch.stack([p["router"] for p in params]) if ranked else params["router"]
    probs, top_p, top_e = _route(xf, router, k)  # (R, T, ...)
    P_i = rank_mean(probs.mean(1))
    rows = torch.arange(R, device=dev)[:, None].expand(R, T * k)
    flat_e = top_e.reshape(R, T * k)
    f_i = rank_mean(_counts(rows * E + flat_e, R * E).reshape(R, E) / (T * k))
    aux = _aux(cfg, P_i, f_i)

    # -- dispatch: (n, C_pair, d) send buffers per row ------------------
    dest = flat_e // E_loc  # owner device per assignment
    pos = _positions((rows * n + dest).reshape(-1), R * n).reshape(R, T * k)
    C_pair = _bucket_capacity(T * k, n, cfg.capacity_factor)
    xe = xs if eg is not None else xf
    xk = xe[:, :, None].expand(R, T, k, d).reshape(R, T * k, d)
    send = _put((R, n, C_pair), (rows, dest, pos), xk)
    send_e = _put((R, n, C_pair), (rows, dest, pos), flat_e.to(torch.int32), fill=-1)

    # -- the wire: tokens (and their expert ids) to the expert owners --
    recv = exchange(send, wire_dtype)
    recv_e = exchange(send_e)

    # -- receiver-side dispatch into (E_loc, C_loc, d) per row ----------
    re = recv_e.reshape(R, n * C_pair).long()
    le = re - ids[:, None] * E_loc  # local expert index
    valid = (re >= 0) & (le >= 0) & (le < E_loc)
    C_loc = _bucket_capacity(n * C_pair, E_loc, cfg.capacity_factor)
    le_s = torch.where(valid, le, E_loc)  # E_loc: dropped
    rows2 = torch.arange(R, device=dev)[:, None].expand(R, n * C_pair)
    pos2 = _positions((rows2 * (E_loc + 1) + le_s).reshape(-1), R * (E_loc + 1))
    pos2 = torch.where(valid, pos2.reshape(R, n * C_pair), C_loc)
    buf = _put((R, E_loc, C_loc), (rows2, le_s, pos2), recv.reshape(R, n * C_pair, d))

    # -- each row's expert block (row r's local expert j is r·E_loc + j)
    if ranked:  # row r's block from tree r, cast per block
        w = [torch.cat([cast(p[name][r * E_loc : (r + 1) * E_loc]) for r, p in enumerate(params)])
             for name in ("wg", "wu", "wd")]
    elif group is None:
        w = [params[name] for name in ("wg", "wu", "wd")]
    else:  # this rank's experts: its owned ones that lie in its model block
        me = cwd.group_rank(group)
        lo, hi, at = me * E_loc, (me + 1) * E_loc, 0
        if eg is not None:
            E_tp = E // dist.get_world_size(eg)
            at = dist.get_rank(eg) * E_tp  # the first expert this rank holds
            lo, hi = max(lo, at), min(hi, at + E_tp)
            hi = max(hi, lo)  # no owned expert in the model block
        w = [params[name][lo - at:hi - at] for name in ("wg", "wu", "wd")]
    if group is not None and eg is not None:  # the other owned experts read zeros
        j0, j1 = lo - me * E_loc, hi - me * E_loc
        ran = _experts(buf[0, j0:j1], *w)
        out_buf = torch.cat([ran.new_zeros((j0,) + ran.shape[1:]), ran,
                             ran.new_zeros((E_loc - j1,) + ran.shape[1:])])[None]
    else:
        out_buf = _experts(buf.reshape(R * E_loc, C_loc, d), *w)
        out_buf = out_buf.reshape(R, E_loc, C_loc, d)

    # -- results back to the token owners, combine at the source --------
    back = _take(out_buf, (rows2, le_s, pos2)).reshape(R, n, C_pair, d)
    ret = exchange(back, wire_dtype)
    gathered = _take(ret, (rows, dest, pos)).reshape(R, T, k, d)
    if eg is None and sg is None:
        out = _with_shared(params, cfg, xf, _combine(gathered, top_p))
    else:  # summed over model with the shared experts' column blocks
        out = _tp_out(params, cfg, xf, xs, _combine(gathered, copy_to_tp(top_p, eg)), eg, sg)
    return out.to(x.dtype).reshape(R, B, S, d), aux


def _moe_apply_ep_auto(params: dict | list[dict], x: torch.Tensor, cfg: ModelConfig):
    """Route ``cfg.moe_ep_dispatch``: with a virtual mesh named by
    ``parallel.hints.set_mesh`` whose DP group divides the experts and
    the batch, split the batch into that many rows, run
    :func:`moe_apply_ep` on them and merge; with a mesh whose DP axes
    have a process group (``mesh.group``) that divides the experts, run
    this rank's tokens through its process form, composed with the
    experts' split over a live ``model`` axis (:func:`moe_apply_ep`'s
    ``tp_groups``); anything else (no mesh, no DP axis, indivisible
    experts or batch) takes the single-device path, which per-row params
    (a list) cannot take. The global batch JAX's ``shard_map`` would
    split over the DP axes is the ranks' rows together, or, inside
    ``hints.replicated_batch`` (``long_500k``: one sequence on every
    rank), the rank's own rows, which one token never divides: that
    falls back as JAX's does, the flat path taking the one token's
    capacity."""

    def fallback():
        if isinstance(params, list):
            raise ValueError("per-row MoE params need an expert-parallel group: "
                             "name a DP mesh that divides the experts and the batch")
        if cfg.moe_row_dispatch:
            return moe_apply_rowwise(params, x, cfg)
        return _moe_apply_flat(params, x, cfg)

    mesh = hints.concrete_mesh()
    if mesh is None:
        return fallback()
    dp = hints.dp_axes(mesh.axis_names)
    if not dp:
        return fallback()
    n = math.prod(mesh.shape[a] for a in dp)
    group = mesh.group(dp)
    if cfg.num_experts % n or (group is None and x.shape[0] % n):
        return fallback()
    if group is not None and n > 1 and hints.batch_replicated():
        if x.shape[0] % n:
            return fallback()
        raise NotImplementedError(
            f"moe_ep_dispatch on {x.shape[0]} replicated rows over {n} DP ranks: JAX's "
            "shard_map would split them; only a batch the DP ranks do not divide (which "
            "falls back) is ported")
    # moe_ep_chains must divide the EP group; degrade to the single ring
    K = cfg.moe_ep_chains if cfg.moe_ep_chains > 1 and n % cfg.moe_ep_chains == 0 else 1
    if group is not None:  # this rank's tokens, exchanged over the mesh's DP group
        out, aux = moe_apply_ep(params, x[None], cfg, num_chains=K,
                                wire_dtype="int8" if cfg.moe_ep_int8_wire else None,
                                group=group, tp_groups=_tp_groups(cfg))
        return out[0], aux
    B, S, d = x.shape
    out, aux = moe_apply_ep(
        params, x.reshape(n, B // n, S, d), cfg, num_chains=K,
        wire_dtype="int8" if cfg.moe_ep_int8_wire else None)
    return out.reshape(B, S, d), aux


def moe_ref(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: dense per-token loop over top-k experts (no capacity)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    _, top_p, top_e = _route(xf, params["router"], cfg.moe_top_k)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        he = F.silu(matmul(xf, params["wg"][e])) * matmul(xf, params["wu"][e])
        ye = matmul(he, params["wd"][e]).float()
        w = torch.where(top_e == e, top_p, 0.0).sum(-1)
        out = out + ye * w[:, None]
    out = _with_shared(params, cfg, xf, out)
    return out.to(x.dtype).reshape(B, S, d)


__all__ = [
    "capacity",
    "moe_apply",
    "moe_apply_ep",
    "moe_apply_rowwise",
    "moe_init",
    "moe_ref",
]
