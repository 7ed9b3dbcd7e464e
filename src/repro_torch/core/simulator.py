"""Cycle-level NoC model for the paper's evaluation (Fig. 5, 7, 9/10).

The paper measures latency with RTL/FPGA hardware counters; we cannot
synthesize RTL here, so this module is an analytical cycle model of the
same three P2MP mechanisms on the same NoC (2-D mesh, XY routing,
64 B/cycle links):

* ``unicast_latency``   — iDMA-style software P2MP: N sequential P2P
  copies, each re-reading the source (η_P2MP ≤ 1 by construction).
* ``multicast_latency`` — ESP-style network-layer multicast: one stream,
  routers replicate at branch points; setup cost grows superlinearly
  with N_dst (the paper's observed behaviour).
* ``chainwrite_latency`` — Torrent: four-phase orchestration
  (cfg dispatch ∥, grant ⇠, pipelined frame store-and-forward data ⇢,
  finish ⇠).
* ``program_latency`` / ``program_wire_bytes`` — the generic models
  over the :mod:`repro.core.program` schedule IR: any
  :class:`ChainProgram` gets the staggered-cfg/grant/finish machinery
  (all groups' cfg packets serialize through the initiator's single
  cfg-inject port) with a kind-aware data phase — one pipelined
  store-and-forward stream per chain for ``kind="pipeline"``, the sum
  of per-step (slowest-edge hops + fill + frame/BW) rounds for
  ``kind="stepped"``. Every concrete model below is a thin
  ``plan_* -> program_latency`` wrapper.
* ``multi_chain_latency`` — K concurrent Chainwrite chains from one
  initiator (``scheduling.partition_schedule``): ``program_latency``
  of ``plan_broadcast``. Reduces exactly to ``chainwrite_latency`` at
  K=1. ``choose_num_chains`` picks K by argmin of this model.
* ``all_reduce_latency`` — algo-aware model of the K-sub-ring
  all-reduce schedules (``multi_chain_all_reduce``):
  ``program_latency`` of ``plan_all_reduce`` — full payloads for
  ``rotation``, 1/S shards for ``rs_ag`` — so
  ``choose_num_chains(collective="all_reduce")`` picks K from modeled
  bytes *and* cycles. ``choose_num_chains`` extends the same
  byte/latency model to ``reduce_scatter`` / ``all_gather`` /
  ``all_to_all`` via their planners.
* ``chain_recovery_latency`` — failure/recovery extension: one *or
  several* chain members die concurrently, the initiator times out
  (``fail_timeout_cc``), re-forms each orphaned suffix
  (``scheduling.reform_chain``) and re-dispatches the cfgs through the
  same single cfg-inject port; the data is re-sent from the last
  surviving upstream member (store-and-forward banked the payload
  there). The whole recovery schedule is a ``program.plan_recovery``
  ChainProgram priced by ``program_latency`` — recovery bytes appear
  in ``program_wire_bytes`` like any other collective's. Isolation
  invariant: chains without a failed member complete at *exactly*
  their ``multi_chain_latency`` per-chain time. A dead *initiator* is
  unrecoverable: :class:`SourceFailedError`.

Calibration: the model's per-destination marginal overhead for a
1-hop-spaced chain is **82 cycles**, matching the paper's measured
Fig. 7 slope; the split across phases (cfg/grant/fill/finish) is a
modeling choice documented on :class:`SimParams`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from . import program as prg
from .program import ALL_REDUCE_ALGOS, ChainProgram, program_wire_bytes
from .scheduling import (
    SCHEDULERS,
    FailureSpec,
    chain_total_cost,
    normalize_failed,
    partition_schedule,
)
from .topology import MeshTopology


class SourceFailedError(ValueError):
    """The failed node is the chain *initiator* — total loss, not a
    recoverable member failure. Endpoint-side re-forming cannot help
    (nobody upstream banked the payload, and the cfg port died with the
    source); callers must fall back to checkpoint rollback
    (``runtime.failure.resilient_loop`` does exactly that)."""


@dataclasses.dataclass(frozen=True)
class SimParams:
    """NoC and Torrent timing constants (defaults = paper's system).

    The per-destination Chainwrite overhead decomposes as
    ``3*router_cc + cfg_inject_cc + grant_fwd_cc + finish_fwd_cc +
    sf_fill_cc = 3 + 4 + 16 + 16 + 43 = 82`` cycles for adjacent
    (1-hop) chain members — the Fig. 7 slope. The split between phases
    is not observable in the paper; only the sum is calibrated.
    """

    link_bw: int = 64  # bytes / cycle / link (paper system AXI BW)
    router_cc: int = 1  # per-hop router+wire latency (head flit)
    dma_setup_cc: int = 12  # local DSE start-up (all mechanisms)
    # Chainwrite four-phase constants:
    cfg_inject_cc: int = 4  # initiator serializes one cfg per member
    cfg_proc_cc: int = 24  # cfg decode at a member (once, parallel)
    grant_fwd_cc: int = 16  # per-node grant forward latency
    finish_fwd_cc: int = 16  # per-node finish forward latency
    sf_fill_cc: int = 43  # per-hop store-and-forward pipeline fill
    # ESP-style multicast setup model (superlinear in N_dst):
    mcast_setup_base_cc: int = 40
    mcast_setup_per_dst_cc: int = 6
    mcast_setup_quad_cc: float = 4.7  # grows faster than Torrent's linear
    # Failure recovery: cycles the initiator waits for a missing finish
    # before declaring a chain member dead and re-forming around it.
    fail_timeout_cc: int = 512
    # Initiator memory-read bandwidth shared by K concurrent data
    # streams (bytes/cycle). None = no contention (each stream reads at
    # full link_bw), which keeps every pinned latency unchanged.
    src_read_bw: int | None = None


DEFAULT_PARAMS = SimParams()


# ---------------------------------------------------------------------------
# Latency models
# ---------------------------------------------------------------------------


def p2p_latency(
    topo: MeshTopology,
    src: int,
    dst: int,
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
) -> int:
    """One wormhole-pipelined P2P copy."""
    hops = topo.weighted_distance(src, dst)
    bw = max(1, min(p.link_bw, int(p.link_bw * topo.path_min_bw(src, dst))))
    return p.dma_setup_cc + hops * p.router_cc + _ceil_div(size_bytes, bw)


def unicast_latency(
    topo: MeshTopology,
    src: int,
    dsts: Sequence[int],
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
) -> int:
    """iDMA software P2MP: sequential P2P copies (paper baseline)."""
    return sum(p2p_latency(topo, src, d, size_bytes, p) for d in dsts)


def multicast_latency(
    topo: MeshTopology,
    src: int,
    dsts: Sequence[int],
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
) -> int:
    """ESP-style network-layer multicast.

    One stream; replication in routers, all branches progress in
    parallel → data phase is bounded by the farthest destination.
    Setup grows superlinearly with N_dst (multicast route tables and VC
    allocation across the destination set).
    """
    n = len(dsts)
    setup = (
        p.dma_setup_cc
        + p.mcast_setup_base_cc
        + p.mcast_setup_per_dst_cc * n
        + int(p.mcast_setup_quad_cc * n * n)
    )
    far = max(topo.weighted_distance(src, d) for d in dsts)
    bw = max(
        1,
        min(
            p.link_bw,
            int(p.link_bw * min(topo.path_min_bw(src, d) for d in dsts)),
        ),
    )
    return setup + far * p.router_cc + _ceil_div(size_bytes, bw)


def _effective_bw(p: SimParams, streams: int) -> int:
    """Per-stream source-read bandwidth with ``streams`` concurrent
    data streams sharing the initiator's memory port
    (``src_read_bw=None`` = no contention -> full link_bw)."""
    if p.src_read_bw is None or streams <= 1:
        return p.link_bw if p.src_read_bw is None else min(
            p.link_bw, p.src_read_bw
        )
    return max(1, min(p.link_bw, p.src_read_bw // streams))


def _cfg_phase(
    topo: MeshTopology,
    src: int,
    order: Sequence[int],
    p: SimParams,
    injected: int,
) -> int:
    """Cfg-dispatch phase shared by every chain-shaped schedule: the
    initiator serializes ``injected`` cfg packets through its single
    cfg-inject port; packets race to members in parallel; the chain is
    ready when the farthest (by weighted route latency) member has
    decoded its cfg."""
    far = max(topo.weighted_distance(src, d) for d in order)
    return (
        p.dma_setup_cc
        + injected * p.cfg_inject_cc
        + far * p.router_cc
        + p.cfg_proc_cc
    )


def _chain_phases(
    topo: MeshTopology,
    src: int,
    head: int,
    order: Sequence[int],
    size_bytes: int,
    p: SimParams,
    *,
    injected: int,
    streams: int = 1,
) -> tuple[int, int, int, int]:
    """Four-phase (cfg, grant, data, finish) split of one chain.

    ``src`` is the cfg initiator (owner of the single cfg-inject port:
    ``injected`` counts every cfg packet serialized through it up to
    and including this chain's); ``head`` is where the data stream
    enters the chain (= ``src`` normally, the last surviving upstream
    member during recovery). ``streams`` is the number of concurrent
    data streams sharing ``src_read_bw``.

    * cfg — initiator serializes ``injected`` cfg packets; packets race
      to members in parallel; the chain is ready when the farthest
      member has decoded its cfg.
    * grant / finish — tail -> head along the chain.
    * data — one pipelined stream through the chain: per-hop
      store-and-forward fill, then streaming at the effective
      bandwidth, bottlenecked by the slowest link on the chain's routes
      (``path_min_bw``; a no-op on a uniform topology).

    Hop terms are weighted link latencies (``chain_total_cost``), so a
    uniform mesh prices CC-identically to the pre-tiering model while a
    tiered topology charges slow inter-pod links honestly.
    """
    n = len(order)
    chain_hops = chain_total_cost(topo, order, head)
    cfg = _cfg_phase(topo, src, order, p, injected)
    grant = chain_hops * p.router_cc + n * p.grant_fwd_cc
    bw = _effective_bw(p, streams)
    frac = _chain_min_bw(topo, order, head)
    if frac < 1.0:
        bw = max(1, min(bw, int(p.link_bw * frac)))
    data = (
        chain_hops * p.router_cc
        + n * p.sf_fill_cc
        + _ceil_div(size_bytes, bw)
    )
    finish = chain_hops * p.router_cc + n * p.finish_fwd_cc
    return cfg, grant, data, finish


def _chain_min_bw(
    topo: MeshTopology, order: Sequence[int], head: int
) -> float:
    """Bottleneck link bandwidth fraction over the chain's routes."""
    frac = topo.path_min_bw(head, order[0])
    for a, b in zip(order, order[1:]):
        f = topo.path_min_bw(a, b)
        if f < frac:
            frac = f
    return frac


def chainwrite_latency(
    topo: MeshTopology,
    src: int,
    order: Sequence[int],
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
) -> int:
    """Torrent Chainwrite: four-phase orchestration latency.

    ``order`` is the scheduled destination traversal order (chain =
    src -> order[0] -> ... -> order[-1]).
    """
    if not order:
        return 0
    return sum(
        _chain_phases(
            topo, src, src, order, size_bytes, p, injected=len(order)
        )
    )


def program_latency(
    topo: MeshTopology,
    src: int,
    program: ChainProgram,
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
    *,
    detail: bool = False,
) -> int | dict[str, object]:
    """Four-phase latency of any :class:`ChainProgram` — the generic
    model every per-collective wrapper is a thin planner around.

    Shared machinery (``program.groups`` = the chains/rings): the
    initiator serializes every group's cfg packets through its single
    cfg-inject port in group order (group ``c`` becomes ready only
    after groups ``0..c``'s cfgs), and each group pays its own
    tail->head grant and finish forwarding. The data phase is
    kind-aware:

    * ``kind="pipeline"`` — one wormhole-pipelined store-and-forward
      stream per chain, entering at the group's data head
      (``program.group_heads``, default: the initiator) — chain hops +
      per-member fill + payload at the per-stream effective bandwidth:
      streams sharing one data head (e.g. K broadcast chains all read
      from the initiator) share its ``src_read_bw``;
    * ``kind="stepped"``  — the schedule's rounds run lockstep: each
      step costs its slowest edge's router hops + one
      store-and-forward fill + frame bytes (``width/addr_shards`` of
      the payload) over the link bandwidth; every device drives one
      outgoing stream at a time (``streams=1``).

    Edge-free ``tag="detect"`` steps (the failure-detection window of a
    recovery program) each charge ``p.fail_timeout_cc``, added to every
    group's completion — they move no bytes.

    Completion = max over groups of the staggered-cfg four-phase sum.
    With ``detail=True`` returns ``{"total", "per_chain", "per_phase",
    "detect_cc"}`` (plus the program's modeled ``wire_bytes``).
    """
    heads = program.group_heads or (src,) * len(program.groups)
    pairs = [
        (list(c), int(h))
        for c, h in zip(program.groups, heads)
        if len(c)
    ]
    detect = p.fail_timeout_cc * sum(
        1 for s in program.steps if s.tag == "detect"
    )
    empty = {
        "total": detect, "per_chain": [], "per_phase": [],
        "detect_cc": detect, "wire_bytes": 0,
    }
    if not pairs:
        return dict(empty) if detail else detect

    per_chain: list[int] = []
    per_phase: list[tuple[int, int, int, int]] = []
    injected = 0  # cfg packets already serialized through the port

    if program.kind == "pipeline":
        streams_per_head: dict[int, int] = {}
        for _, h in pairs:
            streams_per_head[h] = streams_per_head.get(h, 0) + 1
        for order, head in pairs:
            injected += len(order)
            phases = _chain_phases(
                topo, src, head, order, size_bytes, p,
                injected=injected, streams=streams_per_head[head],
            )
            per_phase.append(phases)
            per_chain.append(sum(phases) + detect)
    else:  # stepped: lockstep rounds, shared by every ring
        bw = _effective_bw(p, 1)  # one outgoing stream per device
        # Steps share their edge tuples (one intra + one cross list per
        # program), so the O(edges) worst-edge scan memoizes by identity
        # — 1024-ring pricing stays O(L), not O(L²). Each step pays its
        # slowest edge's weighted hop cost and streams its frame at the
        # step's bottleneck link bandwidth (uniform: full link_bw).
        costs_memo: dict[int, tuple[int, float]] = {}
        data = 0
        for step in program.steps:
            ec = costs_memo.get(id(step.edges))
            if ec is None:
                ec = _edge_costs(topo, step.edges)
                costs_memo[id(step.edges)] = ec
            eh, frac = ec
            sbw = (
                bw if frac >= 1.0
                else max(1, min(bw, int(p.link_bw * frac)))
            )
            data += (
                eh * p.router_cc
                + p.sf_fill_cc
                + _ceil_div(program.step_bytes(step, size_bytes), sbw)
            )
        for order, _ in pairs:
            injected += len(order)
            cfg = _cfg_phase(topo, src, order, p, injected)
            hops = _ring_hops(topo, order)
            grant = hops * p.router_cc + len(order) * p.grant_fwd_cc
            finish = hops * p.router_cc + len(order) * p.finish_fwd_cc
            per_phase.append((cfg, grant, data, finish))
            per_chain.append(cfg + grant + data + finish + detect)

    total = max(per_chain)
    if detail:
        return {
            "total": total,
            "per_chain": per_chain,
            "per_phase": per_phase,
            "detect_cc": detect,
            "wire_bytes": program.wire_bytes(size_bytes),
        }
    return total


def multi_chain_latency(
    topo: MeshTopology,
    src: int,
    chains: Sequence[Sequence[int]],
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
    *,
    detail: bool = False,
) -> int | dict[str, object]:
    """K concurrent four-phase Chainwrites sharing one cfg-inject port —
    ``program_latency`` of the broadcast program.

    Contention model (the only coupling between chains): the initiator
    has a single cfg-inject port, so the cfg packets of **all** chains
    serialize through it in chain order — chain ``c`` can only become
    ready once the cfgs of chains ``0..c`` have been injected. Data,
    grant and finish phases run concurrently per chain (the partitioner
    prefers link-disjoint XY paths, and the paper's XDMA dispatches
    independent engines per chain), so completion is the max over
    chains of their four-phase latency with the staggered cfg start.

    ``multi_chain_latency(topo, src, [order], size)`` reduces *exactly*
    to ``chainwrite_latency(topo, src, order, size)`` — pinned by the
    tier-1 regression tests together with the 82 CC/destination Fig. 7
    slope.

    With ``detail=True`` returns ``{"total", "per_chain",
    "per_phase"}`` where ``per_phase`` holds each chain's
    ``(cfg, grant, data, finish)`` split.
    """
    clean = tuple(tuple(int(d) for d in c) for c in chains if len(c))
    if not clean:
        return (
            {"total": 0, "per_chain": [], "per_phase": [], "wire_bytes": 0}
            if detail
            else 0
        )
    program = prg.plan_broadcast(topo.num_nodes, int(src), clean)
    return program_latency(topo, src, program, size_bytes, p, detail=detail)


def chain_recovery_latency(
    topo: MeshTopology,
    src: int,
    chains: Sequence[Sequence[int]],
    failed: FailureSpec,
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
    *,
    scheduler: str = "tsp",
    detail: bool = False,
) -> int | dict[str, object]:
    """Multi-chain completion latency when chain member(s) ``failed``
    die — one node id or a set of concurrently dead members.

    Since the recovery-as-a-program refactor this is a thin wrapper:
    the whole recovery schedule is planned once by
    :func:`repro.core.program.plan_recovery` (detection window +
    re-formed suffix per affected chain, streaming from the member
    that banked the payload) and priced by the generic
    :func:`program_latency` — so recovery bytes also appear in
    ``program_wire_bytes`` like any other collective's. Composition
    (all endpoint-side — recovery is just a new cfg dispatch, the NoC
    is untouched):

    1. **Detection** — the failed chains run their original four phases
       but the finishes never arrive; the initiator times out
       ``fail_timeout_cc`` after the expected completion (one shared
       window: concurrent failures are detected together).
    2. **Re-cfg dispatch** — each orphaned suffix is re-formed
       (``scheduling.reform_chain``: splice + TSP re-order from the
       surviving tail, torus-aware) and its cfg packets are serialized
       through the same single cfg-inject port — independent per-chain
       recoveries contend only there, exactly like the original
       chains' cfgs in :func:`multi_chain_latency`.
    3. **Re-sent frames** — grant/data/finish per re-formed suffix,
       streamed from the last surviving upstream member (which banked
       the payload during store-and-forward), or from the initiator
       when the failure hit the chain head.

    Isolation invariant (pinned by tests): every chain *without* a
    failed member completes at exactly its ``multi_chain_latency``
    per-chain time — failures never perturb other sub-chains. The
    initiator itself cannot be recovered: ``failed`` containing ``src``
    raises :class:`SourceFailedError` (total loss — roll back to a
    checkpoint instead of re-forming).

    With ``detail=True`` returns the ``multi_chain_latency`` detail
    dict extended with ``failed`` (the sorted failure set),
    ``recovery_wire_bytes`` (the planned program's modeled bytes) and
    a ``recoveries`` list, one entry per affected chain: ``{"chain",
    "failed", "reformed", "resent", "head", "detect_cc", "cfg_cc",
    "grant_cc", "data_cc", "finish_cc", "recovery_cc"}``. When exactly
    one chain is affected the entry is also exposed as ``recovery``
    (the pre-refactor single-failure shape).
    """
    chains = [list(c) for c in chains if len(c)]
    dead = normalize_failed(failed)
    if src in dead:
        raise SourceFailedError(
            f"node {src} is the chain initiator: total loss, "
            "re-forming cannot recover the source"
        )
    members = {d for c in chains for d in c}
    missing = [f for f in dead if f not in members]
    if missing:
        raise ValueError(f"failed node(s) {missing} are in no chain")

    base = multi_chain_latency(topo, src, chains, size_bytes, p, detail=True)
    assert isinstance(base, dict)

    program = prg.plan_recovery(
        topo, src, [tuple(c) for c in chains], dead, scheduler=scheduler
    )
    rec = program_latency(topo, src, program, size_bytes, p, detail=True)
    assert isinstance(rec, dict)

    per_chain = list(base["per_chain"])
    recoveries: list[dict[str, object]] = []
    gi = 0  # index into the program's (non-empty resent) groups
    for ci, order in enumerate(chains):
        chain_dead = [d for d in order if d in dead]
        if not chain_dead:
            continue
        # The geometry comes straight from the planned program (the
        # prefix before the earliest failure is kept verbatim; the
        # program's group is the re-scheduled resent suffix) — the
        # exact-TSP re-schedule runs once, inside plan_recovery.
        first = order.index(chain_dead[0])
        prefix = order[:first]
        orphaned = any(d not in dead for d in order[first + 1 :])
        if orphaned:
            resent = list(program.groups[gi])
            head = program.group_heads[gi]
            cfg, grant, data, finish = rec["per_phase"][gi]
            recovery_cc = rec["per_chain"][gi]  # includes the detection
            gi += 1
        else:  # tail failure: nothing downstream to re-send
            resent = []
            head = prefix[-1] if prefix else src
            cfg = grant = data = finish = 0
            recovery_cc = p.fail_timeout_cc
        reformed = prefix + resent
        per_chain[ci] += recovery_cc
        recoveries.append({
            "chain": ci,
            "failed": chain_dead,
            "reformed": reformed,
            "resent": resent,
            "head": head,
            "detect_cc": p.fail_timeout_cc,
            "cfg_cc": cfg,
            "grant_cc": grant,
            "data_cc": data,
            "finish_cc": finish,
            "recovery_cc": recovery_cc,
        })
    total = max(per_chain)
    if detail:
        out: dict[str, object] = {
            "total": total,
            "per_chain": per_chain,
            "per_phase": list(base["per_phase"]),
            "failed": dead,
            "recoveries": recoveries,
            "recovery_wire_bytes": program.wire_bytes(size_bytes),
        }
        if len(recoveries) == 1:
            out["recovery"] = recoveries[0]
        return out
    return total


def _canonical_rings(ring_size: int, num_chains: int) -> tuple[tuple[int, ...], ...]:
    S, K = int(ring_size), int(num_chains)
    return tuple(
        tuple(range(c * S, (c + 1) * S)) for c in range(K)
    )


def all_reduce_wire_bytes(
    ring_size: int, num_chains: int, size_bytes: int, algo: str = "rs_ag",
    wire_dtype: str | None = None,
) -> int:
    """Per-device wire bytes of the K-sub-ring all-reduce schedules
    (``chainwrite.multi_chain_all_reduce``): S = ``ring_size`` members
    per ring, K = ``num_chains`` rings — ``program_wire_bytes`` of the
    planned schedule (ring membership does not change byte counts, so
    canonical contiguous rings stand in):

    * ``rs_ag``:    (2·(S-1) + (K-1)) shard-sized frames, shard =
      ceil(payload / S) — ≈ (2·(S-1)+(K-1))/S · payload, the
      bandwidth-optimal family (K=1 gives 2·(L-1)/L exactly).
    * ``rotation``: (S + K - 2) full payloads.

    K=1 always delegates to the single-ring reduce-scatter +
    all-gather, so the ``rs_ag`` formula applies for either ``algo``.
    ``wire_dtype="int8"`` prices quarter-size frames plus the per-frame
    f32 scale sideband.
    """
    if algo not in ALL_REDUCE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}; expected {ALL_REDUCE_ALGOS}")
    S, K = int(ring_size), int(num_chains)
    if S < 1 or K < 1:
        raise ValueError("ring_size and num_chains must be >= 1")
    program = prg.plan_all_reduce(
        S * K, _canonical_rings(S, K), algo, wire_dtype=wire_dtype
    )
    return program.wire_bytes(size_bytes)


def _ring_hops(topo: MeshTopology, order: Sequence[int]) -> int:
    """Total weighted link cost around the closed ring (incl. the wrap
    link) — plain hop count on a uniform topology."""
    if len(order) <= 1:
        return 0
    loop = list(order) + [order[0]]
    return sum(topo.weighted_distance(a, b) for a, b in zip(loop, loop[1:]))


def _edge_costs(topo: MeshTopology, edges) -> tuple[int, float]:
    """Per-step cost of one fused rotation: (slowest edge's weighted
    route cost, bottleneck link bandwidth fraction across the edges) —
    the step completes when its slowest edge lands."""
    max_w = 0
    min_bw = 1.0
    for a, b in edges:
        w = topo.weighted_distance(a, b)
        if w > max_w:
            max_w = w
        f = topo.path_min_bw(a, b)
        if f < min_bw:
            min_bw = f
    return max_w, min_bw


def all_reduce_latency(
    topo: MeshTopology,
    src: int,
    orders: Sequence[Sequence[int]],
    size_bytes: int,
    p: SimParams = DEFAULT_PARAMS,
    *,
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    detail: bool = False,
) -> int | dict[str, object]:
    """Analytical latency of the K-sub-ring all-reduce schedules —
    ``program_latency`` of ``plan_all_reduce``.

    Same cfg-port serialization as ``multi_chain_latency`` (the
    initiator injects one cfg per ring member, later rings start after
    earlier rings' cfgs) and the same per-chain grant/finish
    forwarding, with the algo-aware data phase coming straight from the
    planned schedule's steps:

    * ``rotation``:  (S-1) intra + (K-1) cross steps, each a
      full-payload fused ppermute;
    * ``rs_ag``:     2·(S-1) intra + (K-1) cross steps at shard size
      ceil(payload/S) — more steps, S× fewer bytes per step.

    Every step costs its slowest edge's router hops + one
    store-and-forward fill + frame_bytes / effective bandwidth
    (``_effective_bw``; each device drives one outgoing stream at a
    time, so ``streams=1``). Completion = max over rings of the
    staggered-cfg four-phase sum. K=1 reduces — CC-exactly, for either
    ``algo`` — to the single-ring reduce-scatter + all-gather model,
    mirroring ``multi_chain_all_reduce``'s K=1 delegation.

    With ``detail=True`` returns ``{"total", "per_chain", "per_phase",
    "algo", "wire_bytes"}``.
    """
    if algo not in ALL_REDUCE_ALGOS:
        raise ValueError(f"unknown algo {algo!r}; expected {ALL_REDUCE_ALGOS}")
    clean = tuple(tuple(int(d) for d in c) for c in orders if len(c))
    if not clean:
        return (
            {"total": 0, "per_chain": [], "per_phase": [],
             "algo": algo, "wire_bytes": 0}
            if detail
            else 0
        )
    if len(clean) == 1:
        algo = "rs_ag"  # the K=1 delegation path: single-ring RS+AG
    program = prg.plan_all_reduce(
        topo.num_nodes, clean, algo, wire_dtype=wire_dtype
    )
    out = program_latency(topo, src, program, size_bytes, p, detail=detail)
    if detail:
        assert isinstance(out, dict)
        out["algo"] = algo
    return out


def overlap_timeline(
    ready_cc: Sequence[int], comm_cc: Sequence[int]
) -> dict[str, object]:
    """Modeled compute/communication timeline of a bucketed,
    backward-overlapped step (the simulator's first whole-step price —
    everything before this models a lone collective).

    ``ready_cc[i]`` is when bucket i's last gradient leaf exists (its
    compute availability, in NoC cycles — cumulative backward-segment
    estimates from ``launch.roofline.bucket_ready_cc``), nondecreasing
    in dispatch (reverse-topological) order; ``comm_cc[i]`` is that
    bucket's chain all-reduce latency (``program_latency`` /
    ``all_reduce_latency``). Buckets serialize on the NoC — one cfg
    port, one outgoing stream per device — so bucket i starts at
    ``max(ready[i], finish[i-1])``:

    * ``overlap_cc``  — finish of the last bucket (modeled overlapped
      step time: comm runs behind the remaining backward);
    * ``serial_cc``   — ``ready[-1] + sum(comm)`` (the per-leaf status
      quo: every reduction waits for the whole backward);
    * ``hidden_cc``   — serial − overlapped = comm hidden behind compute;
    * ``efficiency``  — hidden / total comm (1.0 = fully hidden; 0.0 =
      nothing overlapped, e.g. a single bucket).
    """
    ready = [int(r) for r in ready_cc]
    comm = [int(c) for c in comm_cc]
    if len(ready) != len(comm):
        raise ValueError(
            f"{len(ready)} ready times for {len(comm)} comm latencies"
        )
    if any(r < 0 for r in ready) or any(c < 0 for c in comm):
        raise ValueError("ready/comm cycles must be non-negative")
    if any(a > b for a, b in zip(ready, ready[1:])):
        raise ValueError(
            "ready_cc must be nondecreasing (dispatch order = "
            "reverse-topological bucket order)"
        )
    start, finish = [], []
    t = 0
    for r, c in zip(ready, comm):
        t = max(r, t)
        start.append(t)
        t += c
        finish.append(t)
    compute_cc = ready[-1] if ready else 0
    overlap = max(compute_cc, finish[-1] if finish else 0)
    total_comm = sum(comm)
    serial = compute_cc + total_comm
    hidden = serial - overlap
    return {
        "overlap_cc": overlap,
        "serial_cc": serial,
        "hidden_cc": hidden,
        "comm_cc": total_comm,
        "compute_cc": compute_cc,
        "efficiency": (hidden / total_comm) if total_comm else 0.0,
        "start_cc": start,
        "finish_cc": finish,
    }


def choose_num_chains(
    topo: MeshTopology,
    src: int,
    dsts: Sequence[int],
    size_bytes: int,
    *,
    max_chains: int = 4,
    scheduler: str = "tsp",
    p: SimParams = DEFAULT_PARAMS,
    collective: str = "broadcast",
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
    buckets: Sequence[tuple[int, int]] | None = None,
    detail: bool = False,
) -> tuple[int, list[list[int]]] | dict[str, object]:
    """Pick K (1..max_chains) minimizing the calibrated model; ties go
    to fewer chains. Returns ``(k, chains)``; with ``detail=True``
    returns ``{"num_chains", "rings", "algo", "wire_dtype",
    "latency_cc"}`` instead (the extra selected dimensions).

    ``collective="broadcast"`` (default) partitions ``dsts`` into K
    sub-chains scored by ``multi_chain_latency`` (PR 1 behaviour;
    ``algo`` is ignored). Because K=1 is always a candidate and
    ``partition_schedule`` with ``num_chains=1`` reproduces the
    single-chain schedule exactly, the returned partition's latency
    never exceeds the K=1 schedule's.

    Every ring collective — ``"all_reduce"``, ``"reduce_scatter"``,
    ``"all_gather"``, ``"all_to_all"`` — goes through the unified
    program model: schedule the closed ring ``src -> dsts`` (the same
    snake construction as ``parallel.collectives.ring_order_for_axis``),
    split it into every K ≤ max_chains that divides the group size, and
    score the candidate sub-ring sets with ``program_latency`` of that
    collective's planner — so K is chosen from modeled *bytes and
    cycles*. Returns the winning ``(k, sub_rings)``; K=1 is always a
    candidate, so the result never models worse than the single ring.
    On a tiered topology (``topo.num_pods > 1``) the pod-aligned split
    — one sub-ring per pod — joins the candidate set (scored first, so
    it wins ties), which is how hierarchical all-reduce becomes a
    planning outcome rather than a hand-set K=#pods special case.

    The all-reduce selection is JOINT over (K, algo, wire_dtype):
    ``algo="auto"`` scores both :data:`ALL_REDUCE_ALGOS` and
    ``wire_dtype="auto"`` scores the payload dtype against the int8
    wire (whose fixed f32-scale sideband makes tiny payloads prefer
    uncompressed frames). A concrete ``algo``/``wire_dtype`` pins that
    dimension. Ties keep the earlier candidate: fewer chains, then
    ``rs_ag``, then the uncompressed wire.

    ``buckets`` (``collective="all_reduce"`` only) switches to the
    bucket-aware STEP-time mode: a sequence of ``(ready_cc,
    size_bytes)`` per bucket in dispatch order, and every (K, algo,
    wire_dtype) candidate is scored by :func:`overlap_timeline`'s
    ``overlap_cc`` — the modeled overlapped step time over ALL buckets
    — instead of one collective's latency (``size_bytes`` is then
    ignored). ``detail=True`` adds ``step_cc`` and the winning
    ``timeline``.
    """
    if buckets is not None and collective != "all_reduce":
        raise ValueError(
            f'buckets= requires collective="all_reduce", got {collective!r}'
        )
    dsts = list(dict.fromkeys(dsts))
    if collective == "broadcast":
        if not dsts:
            return 1, []
        chains = partition_schedule(
            topo, dsts, src,
            scheduler=scheduler,
            max_chains=max_chains,
            cost_fn=lambda cs: multi_chain_latency(topo, src, cs, size_bytes, p),
        )
        if detail:
            return {
                "num_chains": len(chains), "rings": chains, "algo": None,
                "wire_dtype": None,
                "latency_cc": multi_chain_latency(topo, src, chains, size_bytes, p),
            }
        return len(chains), chains
    if collective not in RING_COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}")
    if collective == "all_reduce":
        algos = ALL_REDUCE_ALGOS if algo == "auto" else (algo,)
        for a in algos:
            if a not in ALL_REDUCE_ALGOS:
                raise ValueError(
                    f"unknown algo {a!r}; expected {ALL_REDUCE_ALGOS}"
                )
    else:
        algos = (algo,)
    if wire_dtype == "auto":
        wire_opts: tuple[str | None, ...] = (None, "int8")
    else:
        wire_opts = (prg.normalize_wire_dtype(wire_dtype),)
    if any(w is not None for w in wire_opts) and collective not in (
        "all_reduce", "all_to_all"
    ):
        raise ValueError(
            f"wire_dtype is not supported for collective={collective!r}"
        )

    if not dsts:
        if detail:
            return {"num_chains": 1, "rings": [[int(src)]], "algo": None,
                    "wire_dtype": None, "latency_cc": 0}
        return 1, [[int(src)]]
    ring = [int(src)] + [int(d) for d in SCHEDULERS[scheduler](topo, dsts, src)]
    n = len(ring)
    # Candidate sub-ring sets. On a tiered topology the POD-ALIGNED
    # split (one sub-ring per pod, members in scheduled-ring order) is
    # scored first: its intra steps stay inside pods and only the K-1
    # cross-ring exchanges touch the slow inter-pod links — so the
    # hierarchical intra-pod RS -> one inter-pod exchange per shard ->
    # intra-pod AG schedule *emerges* from the same argmin that picks K
    # on a flat mesh (and wins ties over equally-priced flat splits).
    candidates: list[tuple[int, list[list[int]]]] = []
    if topo.num_pods > 1:
        by_pod: dict[int, list[int]] = {}
        for m in ring:
            by_pod.setdefault(topo.pod_of(m), []).append(m)
        pod_rings = [by_pod[pid] for pid in sorted(by_pod)]
        if (
            1 < len(pod_rings) <= max_chains
            and len({len(r) for r in pod_rings}) == 1
        ):
            candidates.append((len(pod_rings), pod_rings))
    for k in range(1, max_chains + 1):
        if n % k:
            continue
        size = n // k
        candidates.append(
            (k, [ring[i * size : (i + 1) * size] for i in range(k)])
        )
    if topo.num_pods > 1:
        # The tier-blind twin's ring splits are candidates too — the
        # weighted argmin then runs over a SUPERSET of what a tier-blind
        # planner could pick, so the tier-aware choice is never slower
        # than the blind plan priced on the same links (pinned in
        # benchmarks/bench_collectives._tiered_metrics).
        flat = MeshTopology(topo.nx, topo.ny, topo.torus)
        blind_ring = [int(src)] + [
            int(d) for d in SCHEDULERS[scheduler](flat, dsts, src)
        ]
        if blind_ring != ring:
            for k in range(1, max_chains + 1):
                if n % k:
                    continue
                size = n // k
                candidates.append(
                    (k, [blind_ring[i * size : (i + 1) * size]
                         for i in range(k)])
                )
    best: tuple | None = None
    for k, rings in candidates:
        for a in algos:
            # ONE planned program per (K, algo) candidate; the wire
            # variants are O(1) field replacements sharing its steps
            # (the planner caches hold only the wire-free base).
            base = plan_ring_collective(
                collective, topo.num_nodes, rings, algo=a
            )
            for w in wire_opts:
                program = (
                    base if w is None else base.with_wire_dtype(w)
                )
                if buckets is not None:
                    comms = [
                        program_latency(topo, src, program, sb, p)
                        for _, sb in buckets
                    ]
                    tl = overlap_timeline([r for r, _ in buckets], comms)
                    lat = int(tl["overlap_cc"])
                else:
                    tl = None
                    lat = program_latency(topo, src, program, size_bytes, p)
                assert isinstance(lat, int)
                if best is None or lat < best[0]:
                    best = (lat, k, rings, a, w, tl)
    assert best is not None  # k=1 always divides
    if detail:
        out: dict[str, object] = {
            "num_chains": best[1], "rings": best[2],
            "algo": best[3] if collective == "all_reduce" else None,
            "wire_dtype": best[4], "latency_cc": best[0],
        }
        if buckets is not None:
            out["step_cc"] = best[0]
            out["timeline"] = best[5]
        return out
    return best[1], best[2]


RING_COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")


def plan_ring_collective(
    collective: str,
    num_devices: int,
    orders: Sequence[Sequence[int]],
    *,
    algo: str = "rs_ag",
    wire_dtype: str | None = None,
) -> ChainProgram:
    """Planner dispatch for the ring collectives (the unified seam
    ``choose_num_chains`` and the benchmarks score through)."""
    rings = tuple(tuple(int(d) for d in c) for c in orders if len(c))
    if collective == "all_reduce":
        return prg.plan_all_reduce(num_devices, rings, algo, wire_dtype=wire_dtype)
    if collective == "reduce_scatter":
        if wire_dtype is not None:
            raise ValueError("wire_dtype is not supported for reduce_scatter")
        return prg.plan_reduce_scatter(num_devices, rings)
    if collective == "all_gather":
        if wire_dtype is not None:
            raise ValueError("wire_dtype is not supported for all_gather")
        return prg.plan_all_gather(num_devices, rings)
    if collective == "all_to_all":
        return prg.plan_all_to_all(num_devices, rings, wire_dtype=wire_dtype)
    raise ValueError(f"unknown collective {collective!r}")


# ---------------------------------------------------------------------------
# η_P2MP (paper Eq. 1) and the Fig. 5 sweep
# ---------------------------------------------------------------------------


def eta_p2mp(n_dst: int, size_bytes: int, latency_cc: int, p: SimParams = DEFAULT_PARAMS) -> float:
    """η_P2MP = N_dst * (Size/BW_ideal) / lat  (paper Eq. 1)."""
    return n_dst * (size_bytes / p.link_bw) / latency_cc


def p2mp_efficiency_point(
    topo: MeshTopology,
    src: int,
    dsts: Sequence[int],
    size_bytes: int,
    scheduler: str = "greedy",
    p: SimParams = DEFAULT_PARAMS,
) -> dict[str, float]:
    """One (size, N_dst) test point of the Fig. 5 sweep — all three
    mechanisms' η_P2MP."""
    n = len(dsts)
    order = SCHEDULERS[scheduler](topo, list(dsts), src)
    lat_uni = unicast_latency(topo, src, dsts, size_bytes, p)
    lat_mc = multicast_latency(topo, src, dsts, size_bytes, p)
    lat_cw = chainwrite_latency(topo, src, order, size_bytes, p)
    return {
        "n_dst": n,
        "size_bytes": size_bytes,
        "eta_unicast": eta_p2mp(n, size_bytes, lat_uni, p),
        "eta_multicast": eta_p2mp(n, size_bytes, lat_mc, p),
        "eta_chainwrite": eta_p2mp(n, size_bytes, lat_cw, p),
        "lat_unicast_cc": lat_uni,
        "lat_multicast_cc": lat_mc,
        "lat_chainwrite_cc": lat_cw,
    }


def config_overhead_per_destination(
    topo: MeshTopology,
    src: int = 0,
    size_bytes: int = 64 * 1024,
    max_dsts: int = 8,
    p: SimParams = DEFAULT_PARAMS,
) -> dict[str, object]:
    """Fig. 7 experiment: 64 KB Chainwrite to 1..max_dsts adjacent
    destinations; returns per-destination latencies and the fitted
    linear slope (paper: 82 CC/destination)."""
    lats = []
    for n in range(1, max_dsts + 1):
        dsts = list(range(src + 1, src + 1 + n))  # a row of adjacent nodes
        order = SCHEDULERS["greedy"](topo, dsts, src)
        lats.append(chainwrite_latency(topo, src, order, size_bytes, p))
    # least-squares slope over n = 1..max_dsts
    ns = list(range(1, max_dsts + 1))
    mean_n = sum(ns) / len(ns)
    mean_l = sum(lats) / len(lats)
    slope = sum((n - mean_n) * (l - mean_l) for n, l in zip(ns, lats)) / sum(
        (n - mean_n) ** 2 for n in ns
    )
    return {"latencies_cc": lats, "slope_cc_per_dst": slope}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
