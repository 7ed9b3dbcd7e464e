"""Mamba-2 SSD (state-space duality) mixer: chunked scan and O(1) decode
— the port of ``repro.models.mamba2``.

The SSD form computes, per head h with scalar decay ``a_h = -exp(A_log)``:

    state:  h_t = exp(dt_t a) h_{t-1} + dt_t * (B_t ⊗ x_t)
    out:    y_t = C_t · h_t + D x_t

The full sequence runs the chunked algorithm (Mamba-2 paper §6): within
a chunk of Q tokens the recurrence is expanded into a masked
"attention"; across chunks one per-(batch, head) scalar decay carries
the (N×P) state, looped over the S/Q chunks. Decode is the plain
single-token recurrence; its cache is O(1) in context length: the last
``ssm_conv - 1`` raw ``[x, BC]`` projections in bf16 and the (H, N, P)
f32 state.

All SSD arithmetic is f32; projections are bf16. The params and the
cache carry the JAX package's names and nesting, so weights cross with
``convert.params_from_numpy`` and the weight byte stream is the same.

One departure, in the intra-chunk decay ``exp(Λ_i − Λ_j)``: JAX computes
it over the whole Q×Q square and then selects the lower triangle. Above
the diagonal the exponent is positive, and once a chunk's Σdt passes
~88 it overflows f32 to ``inf``; the selected forward stays finite, but
the backward multiplies that ``inf`` by 0 and JAX's grads are NaN. The
port takes ``exp`` of ``where(mask, Λ_i − Λ_j, -inf)``: the same
subtraction and ``exp`` on every kept entry, so the same forward, and an
exact 0 on every masked one, so finite grads.

Tensor parallelism (the full-sequence forward on a mesh whose ``model``
axis is live and splits ``d_inner``, as ``param_pspecs`` does): a rank
holds the columns of ``in_z``/``in_x``/``conv_x_*`` and the gated-norm
scale for its heads, ``out_proj``'s rows for them (row-parallel, reduced
over the group), and the whole ``in_BC``, ``in_dt``, ``conv_BC_*``,
``dt_bias``, ``A_log`` and ``D``. B, C and dt are computed replicated
and go through ``copy_to_tp`` where the rank's heads take their part
(``A_log``/``D`` as well), so each replicated leaf gets its whole grad.
The gated norm is over the whole ``d_inner``: its sum of squares is
summed over the group. ``param_pspecs`` splits ``d_inner`` wherever the
TP size divides it, whole heads or not; within a head the SSD's
channels are independent given the head's ``dt``, ``A``, ``D`` and its
group's B/C, so a rank whose block cuts a head runs the heads its
block touches with its channels in place and zeros in the others'
(:func:`_head_span`), and keeps its own channels' outputs. Prefill and
decode run the same form; a rank's cache holds its heads' state and a
conv window of its ``x`` columns beside the whole B/C
(``parallel.sharding.place_cache`` says how that differs from
``cache_pspecs``' even split of the window). Where the block cuts a
head, ``cache_pspecs`` leaves the state whole (the TP size does not
divide the heads): each rank updates its channels of it and the ranks'
channels are all-gathered, so every rank holds the whole state.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel import hints
from repro_torch.parallel.tp import all_gather, copy_to_tp, reduce_from_tp

from .config import ModelConfig
from .layers import cast, gated_rmsnorm, matmul, normal, rmsnorm_init


def _dims(cfg: ModelConfig, tp: int = 1):
    """(d_in, H, P, G, N, conv_dim); with ``tp`` > 1, this rank's block
    of ``d_inner`` and of the heads (``G``, ``N`` and ``conv_dim`` stay
    the whole model's: B/C are replicated)."""
    d_in = cfg.d_inner // tp
    H = cfg.ssm_nheads // tp
    P = cfg.ssm_headdim
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * G * N
    return d_in, H, P, G, N, conv_dim


def _tp(cfg: ModelConfig):
    """(group, size, rank) of the active TP group where it splits
    ``d_inner`` (``(None, 1, 0)`` elsewhere)."""
    group = hints.tp_split_group(cfg.d_inner)
    if group is None:
        return None, 1, 0
    return group, dist.get_world_size(group), dist.get_rank(group)


def _head_span(cfg: ModelConfig, tp: int, rank: int) -> tuple[slice, int, bool]:
    """(the heads this rank's block of ``d_inner`` touches, the offset of
    its first channel in the first of them, whether the block cuts a
    head). The rank's ``d_inner / tp`` channels sit at that offset in
    the heads' ``len · P`` channels; a block of whole heads has offset 0
    and fills them."""
    P, d_in = cfg.ssm_headdim, cfg.d_inner // tp
    c0 = rank * d_in
    h0, h1 = c0 // P, -(-(c0 + d_in) // P)
    return slice(h0, h1), c0 - h0 * P, d_in % P != 0


def _spread(t: torch.Tensor, off: int, width: int) -> torch.Tensor:
    """``t``'s channels (last dim) at ``off`` in ``width`` channels, zeros
    around them."""
    return F.pad(t, (off, width - off - t.shape[-1]))


def _whole_state(h: torch.Tensor, off: int, d_in: int, cfg: ModelConfig, group) -> torch.Tensor:
    """The whole (B, H, N, P) state from each rank's (B, heads, N, P)
    state of the heads its block touches: its channels cut out and
    all-gathered over ``group`` (the ranks hold every channel once, in
    rank order)."""
    B, _, N, P = h.shape
    mine = h.permute(0, 2, 1, 3).reshape(B, N, -1)[..., off:off + d_in]
    whole = all_gather(mine, group, -1)  # (B, N, d_inner)
    return whole.reshape(B, N, cfg.ssm_nheads, P).permute(0, 2, 1, 3).contiguous()


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random f32 params from ``gen``: projections kept separate (z/x
    vs B,C/dt, conv_x vs conv_BC), as in the JAX package."""
    d = cfg.d_model
    d_in, H, P, G, N, conv_dim = _dims(cfg)
    s = d ** -0.5
    W = cfg.ssm_conv

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "in_z": normal(gen, (d, d_in), s, device),
        "in_x": normal(gen, (d, d_in), s, device),
        "in_BC": normal(gen, (d, 2 * G * N), s, device),
        "in_dt": normal(gen, (d, H), s, device),
        "conv_x_w": normal(gen, (W, d_in), W ** -0.5, device),
        "conv_x_b": zeros(d_in),
        "conv_BC_w": normal(gen, (W, 2 * G * N), W ** -0.5, device),
        "conv_BC_b": zeros(2 * G * N),
        "dt_bias": zeros(H),
        "A_log": zeros(H),  # a = -exp(A_log) = -1
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(d_in, device),
        "out_proj": normal(gen, (d_in, d), d_in ** -0.5, device),
    }


def _project(params: dict, xin: torch.Tensor):
    """xin @ the separate projections -> (z, x, BC, dt)."""
    return tuple(matmul(xin, params[k]) for k in ("in_z", "in_x", "in_BC", "in_dt"))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps ``w`` (W, C): the
    sum of W shifted products in f32, cast back to the input's dtype."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC.float(), (0, 0, W - 1, 0))
    out = pad[:, 0:S] * w[0].float()
    for k in range(1, W):
        out = out + pad[:, k : k + S] * w[k].float()
    return (out + b).to(xBC.dtype)


def mamba2_apply(params: dict, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunked SSD. xin: (B, S, d_model)."""
    return _ssd_forward(params, xin, cfg)[0]


def mamba2_prefill(params: dict, xin: torch.Tensor,
                   cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode cache (final
    SSM state + conv window tail); under TP, this rank's cache, in the
    layout of :func:`mamba2_init_cache`."""
    out, cache = _ssd_forward(params, xin, cfg)
    group, tp, rank = _tp(cfg)
    _, off, cut = _head_span(cfg, tp, rank)
    if cut:
        cache["ssm"] = _whole_state(cache["ssm"], off, cfg.d_inner // tp, cfg, group)
    return out, cache


def _ssd_forward(params: dict, xin: torch.Tensor,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Output and (conv window, final state of the heads the rank's block
    touches)."""
    B, S, _ = xin.shape
    group, tp, rank = _tp(cfg)
    d_in, _, P, G, N, conv_dim = _dims(cfg, tp)
    heads, off, _ = _head_span(cfg, tp, rank)
    H = heads.stop - heads.start
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    Sp = S + pad
    nc = Sp // Q

    # z and x are this rank's columns; B, C and dt replicated (each goes
    # through copy_to_tp where the rank's heads begin to use it)
    xcol = copy_to_tp(xin, group)
    z, x_raw = matmul(xcol, params["in_z"]), matmul(xcol, params["in_x"])
    BC_raw, dt = matmul(xin, params["in_BC"]), matmul(xin, params["in_dt"])
    W = cfg.ssm_conv
    xBC_raw = torch.cat([x_raw, BC_raw], -1)  # cached for decode
    tail = xBC_raw[:, max(0, S - (W - 1)) :]
    if tail.shape[1] < W - 1:  # left-pad with zeros (conv's implicit state)
        tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    # prefill rounds the conv output to the input's dtype before silu
    # (decode does not): JAX's two roundings, kept
    x = _causal_conv(x_raw, params["conv_x_w"], params["conv_x_b"])
    BC = _causal_conv(BC_raw, params["conv_BC_w"], params["conv_BC_b"])
    x = _spread(F.silu(x.float()), off, H * P)  # its channels in the heads it touches
    BC = copy_to_tp(F.silu(BC.float()), group)
    Bm, Cm = BC.split([G * N, G * N], -1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B,S,H), every head
    A_log, D = params["A_log"], params["D"]
    if group is not None:
        dt = copy_to_tp(dt, group)[..., heads]
        A_log, D = copy_to_tp(A_log, group)[heads], copy_to_tp(D, group)[heads]
    if pad:
        # dt = 0 on padded positions makes the state update an exact
        # identity there (decay exp(0)=1, contribution dt·Bx = 0).
        x, Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm, dt))

    # reshape to heads / groups (all f32 from here); head h reads group
    # h // (H/G), as jnp.repeat does: the groups expanded to every head,
    # then this rank's heads taken (under TP a rank may hold part of a
    # group, or several)
    x = x.reshape(B, nc, Q, H, P)
    rep = cfg.ssm_nheads // G
    Bh = Bm.reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)[:, :, :, heads]  # (B,nc,Q,H,N)
    Ch = Cm.reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)[:, :, :, heads]
    dt = dt.reshape(B, nc, Q, H)
    a = -torch.exp(A_log)  # (H,)
    lam = torch.cumsum(dt * a, dim=2)  # Λ inclusive cumsum within chunk, (B,nc,Q,H)

    # ---- intra-chunk (masked attention form) -------------------------
    # att[i,j] = (C_i·B_j) exp(Λ_i - Λ_j) dt_j  for j <= i; the masked
    # exponent is -inf (exp = 0), never a positive one (see the module doc)
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)  # (B,nc,H,Q,Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xin.device).tril()[..., None]
    diff = lam[:, :, :, None, :] - lam[:, :, None, :, :]  # (B,nc,Q,Q,H)
    decay = torch.exp(torch.where(mask, diff, float("-inf"))).movedim(-1, 2)  # (B,nc,H,Q,Q)
    att = cb * decay * dt.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att, x)

    # ---- chunk states + sequential inter-chunk scan -------------------
    # state contributed by chunk c: S_c = sum_j exp(Λ_last - Λ_j) dt_j B_j ⊗ x_j
    seg = torch.exp(lam[:, :, -1:, :] - lam) * dt  # (B,nc,Q,H)
    S_c = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", seg, Bh, x)  # (B,nc,H,N,P)
    gamma = torch.exp(lam[:, :, -1, :])  # (B,nc,H) chunk total decay

    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xin.device)
    h_before = []  # the state BEFORE each chunk
    for c in range(nc):
        h_before.append(h)
        h = gamma[:, c, :, None, None] * h + S_c[:, c]
    h_before = torch.stack(h_before, 1)  # (B,nc,H,N,P)

    # y_inter[i] = C_i · exp(Λ_i) h_{c-1}
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch * torch.exp(lam)[..., None], h_before)

    y = y_intra + y_inter + x * D[:, None]  # (B,nc,Q,H,P)
    y = y.reshape(B, Sp, H * P)[:, :S, off:off + d_in]
    y = gated_rmsnorm(params["norm"], y, z.float(), cfg.norm_eps, group)
    out = reduce_from_tp(cast(y) @ cast(params["out_proj"]), group)

    # h is the final state (the prefill -> decode handoff): one step
    # past the last emitted one
    return out, {"conv": tail.to(torch.bfloat16), "ssm": h}


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------


def mamba2_init_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    """A zero decode cache of ``batch`` rows; under a live TP group that
    splits ``d_inner``, this rank's: its heads of ``ssm`` (all of them
    where its block cuts a head), and a ``conv`` window of its ``x``
    block beside the whole B/C (``conv_dim`` = ``d_inner / tp + 2·G·N``,
    the layout :func:`mamba2_prefill` writes and :func:`mamba2_decode`
    reads)."""
    _, tp, rank = _tp(cfg)
    d_in, H, P, G, N, _ = _dims(cfg, tp)
    if _head_span(cfg, tp, rank)[2]:
        H = cfg.ssm_nheads
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * G * N), dtype=torch.bfloat16,
                            device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    }


def mamba2_decode(
    params: dict,
    xin: torch.Tensor,  # (B, 1, d_model)
    cache: dict,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One token through the recurrence. Writes the new conv window and
    state into ``cache``'s tensors in place (they may be views of a
    stacked cache) and returns ``cache``. On a live TP group that
    splits ``d_inner`` (the module docstring's form), a rank runs its
    heads: its z/x columns, B/C/dt whole (the heads' part taken), the
    gated norm's sum of squares over the group and ``out_proj``'s
    partial sums reduced over it; where its block cuts a head, the
    heads it touches (:func:`_head_span`), the whole state gathered."""
    B = xin.shape[0]
    group, tp, rank = _tp(cfg)
    d_in, _, P, G, N, _ = _dims(cfg, tp)
    heads, off, cut = _head_span(cfg, tp, rank)
    H = heads.stop - heads.start
    z, x_raw, BC_raw, dt = _project(params, xin[:, 0])

    xBC_t = torch.cat([x_raw, BC_raw], -1)  # (B, conv_dim): this rank's x, all of B/C
    window = torch.cat([cache["conv"], xBC_t[:, None, :]], 1)  # (B,W,conv)
    conv_w = torch.cat([params["conv_x_w"], params["conv_BC_w"]], -1)
    conv_b = torch.cat([params["conv_x_b"], params["conv_BC_b"]], -1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), conv_w) + conv_b
    xBC = F.silu(conv_out)  # no rounding to bf16 before silu here
    x, Bm, Cm = xBC.split([d_in, G * N, G * N], -1)
    x = _spread(x, off, H * P).reshape(B, H, P)
    # every head's groups, then this rank's heads (as _ssd_forward)
    rep = cfg.ssm_nheads // G
    Bh = Bm.reshape(B, G, N).repeat_interleave(rep, dim=1)[:, heads]  # (B,H,N)
    Ch = Cm.reshape(B, G, N).repeat_interleave(rep, dim=1)[:, heads]

    dtv = F.softplus(dt.float() + params["dt_bias"])[:, heads]  # (B,H)
    decay = torch.exp(dtv * -torch.exp(params["A_log"][heads]))  # (B,H)
    state = cache["ssm"][:, heads] if cut else cache["ssm"]
    h = state * decay[..., None, None] + torch.einsum("bh,bhn,bhp->bhnp", dtv, Bh, x)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) + x * params["D"][heads][:, None]
    y = y.reshape(B, 1, H * P)[..., off:off + d_in]
    y = gated_rmsnorm(params["norm"], y, z[:, None, :].float(), cfg.norm_eps, group)
    out = reduce_from_tp(cast(y) @ cast(params["out_proj"]), group)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(_whole_state(h, off, d_in, cfg, group) if cut else h)
    return out, cache


__all__ = [
    "mamba2_apply",
    "mamba2_decode",
    "mamba2_init",
    "mamba2_init_cache",
    "mamba2_prefill",
]
