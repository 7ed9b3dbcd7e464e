"""Chainwrite sequence scheduling (paper §III-D).

Chainwrite exposes the destination traversal order; the total number of
link traversals ("hops") of a P2MP task is the sum of XY-route lengths
between consecutive chain members. Two schedulers from the paper:

* :func:`greedy_schedule` — Alg. 1: iteratively pick the next
  destination whose XY path does not overlap already-used links and is
  shortest; fall back to the nearest remaining destination when no
  link-disjoint candidate exists. O(N^2 * path) — just-in-time.

* :func:`tsp_schedule` — open-path TSP on the XY-distance matrix.
  The paper uses OR-Tools; OR-Tools is unavailable offline so we ship
  our own solver: exact Held–Karp DP for small instances, and
  nearest-neighbour + 2-opt + Or-opt local search beyond that. The
  exact solver is the oracle for the heuristic in tests.

Both return the destination visit order (the source C0 is the implicit
chain head and is not part of the returned list), matching Alg. 1.

Beyond the paper: :func:`partition_schedule` splits one destination set
into K link-disjoint-preferring sub-chains that stream **concurrently**
from the initiator (multi-chain Chainwrite — the distributed-DMA
analogue of partition-based NoC multicast). A single logical chain pays
latency linear in its length; K balanced sub-chains cut the data/grant/
finish critical path to the longest sub-chain while the cfg packets of
all chains still serialize through the initiator's one cfg-inject port
(modelled in :func:`repro.core.simulator.multi_chain_latency`).

Partition heuristic (documented invariants relied on by tests):

1. **Seeding** — K seeds via farthest-point sampling over the
   destination set (first seed = destination closest to the source, as
   in Alg. 1), spreading chains into different mesh regions so their
   XY paths tend to be link-disjoint.
2. **Balanced growth** — remaining destinations are absorbed one at a
   time by the (chain, destination) pair that (a) prefers an XY path
   overlapping no link used by *any* chain so far and (b) minimizes the
   resulting chain's total hops — LPT-style balancing, so per-chain hop
   totals stay within one mesh diameter of each other before ordering.
3. **Re-ordering** — each sub-chain is finally re-ordered by the
   requested scheduler (exact TSP for <= 13 members) and the better of
   (grown order, re-scheduled order) is kept, so a sub-chain never
   costs more hops than the growth order produced.

Balance bound: every chain's hop total is at most
``chain_total_hops(single_schedule)/K + 2*(nx + ny)`` — the slack is
one diameter from LPT imbalance plus one diameter for the extra
source->seed entry edge.

Tier-awareness: all scoring goes through the weighted link-graph
contract (``topo.weighted_distance`` / ``topo.path_tier_crossings``,
see :mod:`.topology`), so on a uniform :class:`MeshTopology` every
ordering and cost reduces exactly to the hop-based behaviour above,
while on a :class:`~.topology.TieredMeshTopology` the growth step
penalizes routes over slow tier>0 (inter-pod) links first and
:func:`partition_schedule` additionally considers the **pod-aligned**
partition (one sub-chain per pod, so each chain crosses the inter-pod
boundary in at most one route segment).
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, Sequence

from .topology import Coord, Link, MeshTopology

# The failure-spec convention every fault-tolerance API shares: one
# node id, or any iterable of ids (see normalize_failed).
FailureSpec = int | Iterable[int]

# ---------------------------------------------------------------------------
# Paper Alg. 1 — greedy link-disjoint heuristic
# ---------------------------------------------------------------------------


def greedy_schedule(
    topo: MeshTopology,
    destinations: Sequence[int],
    source: int = 0,
) -> list[int]:
    """Greedy Chainwrite ordering (paper Algorithm 1).

    Starts from the destination closest to the source, then repeatedly
    selects the candidate whose XY path from the current chain tail
    (a) does not overlap any previously used link and (b) has the
    fewest hops; when no overlap-free candidate exists, falls back to
    the nearest remaining destination.
    """
    if not destinations:
        return []
    remaining = list(dict.fromkeys(destinations))  # dedupe, keep order
    # Start from the destination closest to the source (paper: min(D),
    # "dest closest to C0" — C0 is node 0 at the origin; we use the
    # weighted XY distance, which on a uniform mesh coincides with the
    # hop count and hence min-ID on their layout).
    start = min(
        remaining, key=lambda d: (topo.weighted_distance(source, d), d)
    )
    order = [start]
    remaining.remove(start)
    used_path: set[Link] = set(topo.xy_path(source, start))

    while remaining:
        best: int | None = None
        best_cost: int | None = None  # Alg. 1's bound, weighted
        best_path: list[Link] = []
        tail = order[-1]
        for cand in remaining:
            path = topo.xy_path(tail, cand)
            if set(path) & used_path:
                continue
            w = topo.weighted_distance(tail, cand)
            if best_cost is None or w < best_cost:
                best, best_cost, best_path = cand, w, path
        if best is None:  # fallback: shortest path regardless of overlap
            best = min(
                remaining,
                key=lambda c: (topo.weighted_distance(tail, c), c),
            )
            best_path = topo.xy_path(tail, best)
        order.append(best)
        used_path.update(best_path)
        remaining.remove(best)
    return order


# ---------------------------------------------------------------------------
# Open-path TSP scheduler
# ---------------------------------------------------------------------------


def _pairwise_dist(
    topo: MeshTopology, nodes: Sequence[int]
) -> list[list[int]]:
    return [[topo.weighted_distance(a, b) for b in nodes] for a in nodes]


def _held_karp_open_path(dist: list[list[int]]) -> list[int]:
    """Exact open-path TSP from node 0 (the source) via DP.

    dist is (n+1)x(n+1) with index 0 = source. Returns visiting order of
    indices 1..n (0-based into dist). O(2^n * n^2); used for n <= 13.
    """
    n = len(dist) - 1
    if n == 0:
        return []
    FULL = 1 << n
    INF = float("inf")
    # dp[mask][j] = best cost to start at source, visit set `mask`,
    # ending at destination j (0-based in 0..n-1 -> dist index j+1).
    dp = [[INF] * n for _ in range(FULL)]
    parent: list[list[int]] = [[-1] * n for _ in range(FULL)]
    for j in range(n):
        dp[1 << j][j] = dist[0][j + 1]
    for mask in range(FULL):
        row = dp[mask]
        for j in range(n):
            cj = row[j]
            if cj == INF or not (mask >> j) & 1:
                continue
            dj = dist[j + 1]
            for k in range(n):
                if (mask >> k) & 1:
                    continue
                nmask = mask | (1 << k)
                nc = cj + dj[k + 1]
                if nc < dp[nmask][k]:
                    dp[nmask][k] = nc
                    parent[nmask][k] = j
    last = min(range(n), key=lambda j: dp[FULL - 1][j])
    order_rev = []
    mask, j = FULL - 1, last
    while j != -1:
        order_rev.append(j)
        pj = parent[mask][j]
        mask ^= 1 << j
        j = pj
    return order_rev[::-1]


def _path_cost(dist: list[list[int]], order: list[int]) -> int:
    cost = dist[0][order[0] + 1]
    for a, b in zip(order, order[1:]):
        cost += dist[a + 1][b + 1]
    return cost


def _nearest_neighbour(dist: list[list[int]]) -> list[int]:
    n = len(dist) - 1
    unvisited = set(range(n))
    order: list[int] = []
    cur = 0  # dist index of source
    while unvisited:
        nxt = min(unvisited, key=lambda j: (dist[cur][j + 1], j))
        order.append(nxt)
        unvisited.remove(nxt)
        cur = nxt + 1
    return order


def _two_opt(dist: list[list[int]], order: list[int], max_rounds: int = 60) -> list[int]:
    """2-opt + Or-opt (segment relocation, len 1-3) for the open path.

    Moves are evaluated with O(1) endpoint deltas (node 0 of ``dist`` is
    the fixed source; the path end is open), so a full improvement round
    is O(n^2) rather than O(n^3).
    """
    n = len(order)
    if n < 2:
        return list(order)
    # tour[0] = source sentinel (dist index 0); tour[i>0] = dist index of
    # the (i-1)-th visited destination.
    tour = [0] + [i + 1 for i in order]
    m = len(tour)  # m = n + 1

    def d(i: int, j: int) -> int:
        return dist[tour[i]][tour[j]]

    for _ in range(max_rounds):
        improved = False
        # 2-opt: reverse tour[i..j] for 1 <= i <= j <= m-1. Open path:
        # delta = d(i-1, j) - d(i-1, i) + (d(j, j+1) after - before if
        # j is not the last node).
        for i in range(1, m - 1):
            for j in range(i + 1, m):
                delta = d(i - 1, j) - d(i - 1, i)
                if j < m - 1:
                    delta += d(i, j + 1) - d(j, j + 1)
                if delta < 0:
                    tour[i : j + 1] = tour[i : j + 1][::-1]
                    improved = True
        # Or-opt: relocate segment tour[i..i+seg-1] to after position k.
        for seg in (1, 2, 3):
            i = 1
            while i + seg <= m:
                a, b = i - 1, i + seg  # neighbours of the segment
                # cost removed by excising the segment:
                gain = d(a, i) + (d(i + seg - 1, b) if b < m else 0)
                bridge = dist[tour[a]][tour[b]] if b < m else 0
                best_k, best_delta = -1, -1e-9
                for k in range(1, m):
                    if i - 1 <= k <= i + seg - 1:
                        continue  # overlaps/adjacent-left of segment
                    # insert segment between tour[k] and tour[k+1]
                    add = dist[tour[k]][tour[i]]
                    if k + 1 < m:
                        add += dist[tour[i + seg - 1]][tour[k + 1]]
                        add -= dist[tour[k]][tour[k + 1]]
                    delta = bridge + add - gain
                    if delta < best_delta:
                        best_k, best_delta = k, delta
                if best_k >= 0:
                    segment = tour[i : i + seg]
                    del tour[i : i + seg]
                    k = best_k if best_k < i else best_k - seg
                    tour[k + 1 : k + 1] = segment
                    improved = True
                else:
                    i += 1
        if not improved:
            break
    return [t - 1 for t in tour[1:]]


def tsp_schedule(
    topo: MeshTopology,
    destinations: Sequence[int],
    source: int = 0,
    exact_threshold: int = 13,
) -> list[int]:
    """Open-path TSP Chainwrite ordering (paper §III-D strategy 2).

    Exact (Held–Karp) for ≤ ``exact_threshold`` destinations, otherwise
    nearest-neighbour + 2-opt/Or-opt local search.
    """
    dests = list(dict.fromkeys(destinations))
    if not dests:
        return []
    nodes = [source] + dests
    dist = _pairwise_dist(topo, nodes)
    if len(dests) <= exact_threshold:
        idx_order = _held_karp_open_path(dist)
    else:
        idx_order = _two_opt(dist, _nearest_neighbour(dist))
    return [dests[i] for i in idx_order]


def naive_schedule(
    topo: MeshTopology, destinations: Sequence[int], source: int = 0
) -> list[int]:
    """Naive ordering by cluster ID (the paper's baseline in Fig. 6)."""
    del topo, source
    return sorted(dict.fromkeys(destinations))


SCHEDULERS: dict[str, Callable[..., list[int]]] = {
    "naive": naive_schedule,
    "greedy": greedy_schedule,
    "tsp": tsp_schedule,
}


# ---------------------------------------------------------------------------
# Hop accounting (paper Fig. 6 metric)
# ---------------------------------------------------------------------------


def chain_total_hops(
    topo: MeshTopology, order: Sequence[int], source: int = 0
) -> int:
    """Total link traversals of a Chainwrite visiting ``order``."""
    if not order:
        return 0
    hops = topo.distance(source, order[0])
    for a, b in zip(order, order[1:]):
        hops += topo.distance(a, b)
    return hops


def chain_total_cost(
    topo: MeshTopology, order: Sequence[int], source: int = 0
) -> int:
    """Weighted link-latency total of a Chainwrite visiting ``order``
    (== :func:`chain_total_hops` on a uniform mesh)."""
    if not order:
        return 0
    cost = topo.weighted_distance(source, order[0])
    for a, b in zip(order, order[1:]):
        cost += topo.weighted_distance(a, b)
    return cost


def chain_slow_links(
    topo: MeshTopology, order: Sequence[int], source: int = 0
) -> int:
    """Total tier>0 (inter-pod) links the chain's routes traverse."""
    if not order:
        return 0
    n = topo.path_tier_crossings(source, order[0])
    for a, b in zip(order, order[1:]):
        n += topo.path_tier_crossings(a, b)
    return n


def chain_tier_crossings(
    topo: MeshTopology, order: Sequence[int], source: int = 0
) -> int:
    """Number of consecutive-member route *segments* that traverse at
    least one tier>0 link — a chain that enters a remote pod once and
    stays there counts 1 even when the XY route to a diagonal pod
    happens to cross two boundary links."""
    if not order:
        return 0
    n = 1 if topo.path_tier_crossings(source, order[0]) else 0
    for a, b in zip(order, order[1:]):
        if topo.path_tier_crossings(a, b):
            n += 1
    return n


def partition_tier_crossings(
    topo: MeshTopology, chains: Sequence[Sequence[int]], source: int = 0
) -> list[int]:
    """Per-chain segment-level tier crossings of a partition."""
    return [chain_tier_crossings(topo, c, source) for c in chains]


def unicast_total_hops(
    topo: MeshTopology, destinations: Sequence[int], source: int = 0
) -> int:
    """Total link traversals of N independent unicasts (iDMA model)."""
    return sum(topo.distance(source, d) for d in destinations)


def multicast_total_hops(
    topo: MeshTopology, destinations: Sequence[int], source: int = 0
) -> int:
    """Link traversals of XY network-layer multicast (shared prefixes)."""
    return len(topo.multicast_tree_links(source, list(destinations)))


def brute_force_schedule(
    topo: MeshTopology, destinations: Sequence[int], source: int = 0
) -> list[int]:
    """Exhaustive optimal order — test oracle only (n <= 8)."""
    dests = list(dict.fromkeys(destinations))
    best = None
    best_cost = None
    for perm in itertools.permutations(dests):
        c = chain_total_hops(topo, perm, source)
        if best_cost is None or c < best_cost:
            best, best_cost = list(perm), c
    return best or []


# ---------------------------------------------------------------------------
# Multi-chain partitioning (beyond the paper — see module docstring)
# ---------------------------------------------------------------------------


def partition_balance_slack(topo: MeshTopology) -> int:
    """Additive hop slack of the partition balance bound (two mesh
    diameters — see module docstring)."""
    return 2 * (topo.nx + topo.ny)


def _farthest_point_seeds(
    topo: MeshTopology, dests: list[int], source: int, k: int
) -> list[int]:
    """K spread-out seeds; the first is Alg. 1's closest-to-source."""
    first = min(dests, key=lambda d: (topo.weighted_distance(source, d), d))
    seeds = [first]
    while len(seeds) < k:
        nxt = max(
            (d for d in dests if d not in seeds),
            key=lambda d: (
                min(topo.weighted_distance(d, s) for s in seeds),
                -d,
            ),
        )
        seeds.append(nxt)
    return seeds


def hop_proxy_cost(
    topo: MeshTopology, source: int, per_member_hops: float = 2.4
) -> Callable[[list[list[int]]], float]:
    """Hop-level stand-in for the simulator's multi-chain latency.

    ``per_member_hops`` mirrors the calibrated 82 CC/destination
    overhead expressed in units of the ~34 CC a 1-hop link traversal
    adds to the critical path of a 64 B-granular stream — close enough
    to rank K choices without importing the cycle model (which would be
    a circular import; :mod:`.simulator` builds the calibrated version
    on top via ``choose_num_chains``).
    """

    def cost(chains: list[list[int]]) -> float:
        total_members = sum(len(c) for c in chains)
        worst = max(
            chain_total_cost(topo, c, source) + per_member_hops * len(c)
            for c in chains
        )
        # cfg packets for every member serialize through one port.
        return worst + 0.12 * per_member_hops * total_members

    return cost


def partition_schedule(
    topo: MeshTopology,
    destinations: Sequence[int],
    source: int = 0,
    *,
    num_chains: int | None = None,
    scheduler: str = "tsp",
    max_chains: int = 4,
    cost_fn: Callable[[list[list[int]]], float] | None = None,
) -> list[list[int]]:
    """Split ``destinations`` into K concurrent Chainwrite sub-chains.

    ``num_chains`` fixes K; ``num_chains=None`` auto-selects K in
    ``1..max_chains`` by minimizing ``cost_fn(chains)`` (ties -> fewer
    chains). The default ``cost_fn`` is :func:`hop_proxy_cost`; pass
    the calibrated cycle model through
    :func:`repro.core.simulator.choose_num_chains` instead when the
    topology/size point matters. K=1 returns
    ``[SCHEDULERS[scheduler](...)]`` exactly.

    Returns a list of K destination orders (source excluded, as in the
    single-chain schedulers). Every destination appears in exactly one
    sub-chain.
    """
    dests = list(dict.fromkeys(destinations))
    if not dests:
        return []
    if num_chains is not None:
        return _partition_fixed_k(topo, dests, source, int(num_chains), scheduler)
    if cost_fn is None:
        cost_fn = hop_proxy_cost(topo, source)
    best: list[list[int]] | None = None
    best_cost: float | None = None
    for k in range(1, min(max_chains, len(dests)) + 1):
        chains = _partition_fixed_k(topo, dests, source, k, scheduler)
        c = cost_fn(chains)
        if best_cost is None or c < best_cost:
            best, best_cost = chains, c
    assert best is not None
    return best


def _pod_partition(
    topo: MeshTopology, dests: list[int], source: int, scheduler: str
) -> list[list[int]]:
    """Pod-aligned partition: one sub-chain per pod touched, each
    ordered by the requested scheduler. Every chain enters its pod on
    one route segment and stays there, so it crosses the slow inter-pod
    boundary at most once (``chain_tier_crossings <= 1``)."""
    by_pod: dict[int, list[int]] = {}
    for d in dests:
        by_pod.setdefault(topo.pod_of(d), []).append(d)
    return [
        SCHEDULERS[scheduler](topo, members, source)
        for _, members in sorted(by_pod.items())
    ]


def _partition_fixed_k(
    topo: MeshTopology,
    dests: list[int],
    source: int,
    k: int,
    scheduler: str,
) -> list[list[int]]:
    k = max(1, min(k, len(dests)))
    if k == 1:
        return [SCHEDULERS[scheduler](topo, dests, source)]

    seeds = _farthest_point_seeds(topo, dests, source, k)
    chains: list[list[int]] = [[s] for s in seeds]
    hops = [topo.weighted_distance(source, s) for s in seeds]
    used: set[Link] = set()
    for s in seeds:
        used.update(topo.xy_path(source, s))

    remaining = [d for d in dests if d not in seeds]
    while remaining:
        # Pick the globally best (chain, destination) extension:
        # link-disjoint first (paper Alg. 1's preference), then fewest
        # slow tier>0 links on the extension route, then the smallest
        # resulting weighted chain cost (LPT balancing). On a uniform
        # mesh the slow term is a constant 0 and the weighted costs are
        # hop counts, so the pre-tiering ordering is preserved exactly.
        best_key: tuple | None = None
        best_ci = -1
        best_d = -1
        best_w = 0
        best_path: list[Link] = []
        for ci, chain in enumerate(chains):
            tail = chain[-1]
            for d in remaining:
                path = topo.xy_path(tail, d)
                overlap = bool(set(path) & used)
                w = topo.weighted_distance(tail, d)
                slow = topo.path_tier_crossings(tail, d)
                key = (overlap, slow, hops[ci] + w, w, ci, d)
                if best_key is None or key < best_key:
                    best_key, best_ci, best_d = key, ci, d
                    best_w, best_path = w, path
        chains[best_ci].append(best_d)
        hops[best_ci] += best_w
        used.update(best_path)
        remaining.remove(best_d)

    # Re-order each sub-chain; keep the better of grown vs re-scheduled.
    out: list[list[int]] = []
    for chain in chains:
        rescheduled = SCHEDULERS[scheduler](topo, chain, source)
        if chain_total_cost(topo, rescheduled, source) <= chain_total_cost(
            topo, chain, source
        ):
            out.append(rescheduled)
        else:
            out.append(chain)

    # On a tiered topology, when K matches the number of pods touched,
    # the pod-aligned split (<= 1 boundary crossing per chain) often
    # beats region growth; keep whichever the weighted proxy prefers.
    if topo.num_pods > 1:
        pod_chains = _pod_partition(topo, dests, source, scheduler)
        if len(pod_chains) == k:
            cost = hop_proxy_cost(topo, source)
            if cost(pod_chains) <= cost(out):
                return pod_chains
    return out


def partition_total_hops(
    topo: MeshTopology, chains: Sequence[Sequence[int]], source: int = 0
) -> int:
    """Sum of per-chain hop totals (wire-energy metric; the latency
    metric is the simulator's ``multi_chain_latency``)."""
    return sum(chain_total_hops(topo, c, source) for c in chains)


# ---------------------------------------------------------------------------
# Chain re-forming (fault tolerance — endpoint-only recovery)
# ---------------------------------------------------------------------------


def normalize_failed(failed: FailureSpec) -> list[int]:
    """Canonicalize a failure spec (one node id or an iterable of ids)
    into a sorted duplicate-free list — the failure-*set* convention
    shared by ``reform_chain``, ``simulator.chain_recovery_latency``,
    ``chainwrite.degraded_chains`` and ``MultiChainPlan.reform``."""
    if isinstance(failed, (str, bytes)):
        raise ValueError(f"failed must be a node id or a set of ids, got {failed!r}")
    try:
        it = iter(failed)
    except TypeError:  # a single node id (python or numpy integer)
        return [int(failed)]
    nodes = sorted({int(f) for f in it})
    if not nodes:
        raise ValueError("empty failure set")
    return nodes


def reform_chain(
    topo: MeshTopology,
    order: Sequence[int],
    failed: FailureSpec,
    source: int = 0,
    *,
    scheduler: str = "tsp",
) -> list[int]:
    """Splice the ``failed`` member(s) out of one sub-chain and
    re-order the orphaned suffix — the endpoint-side half of Chainwrite
    fault recovery. ``failed`` is one node id or a set of concurrently
    dead members of this chain.

    Store-and-forward means every member *upstream* of the earliest
    failure has already banked the payload, so that prefix is kept
    verbatim and only the downstream (orphaned) survivors are
    re-planned: they are re-scheduled by the requested scheduler (exact
    TSP for <= 13 members) starting from the surviving chain tail (the
    last prefix member, or the source when a failure hit the chain
    head). The better of the spliced original order and the
    re-scheduled suffix is kept, so re-forming never costs more hops
    than the naive splice.

    All scoring goes through the weighted link-graph contract
    (:meth:`MeshTopology.weighted_distance`), so wrap-around links are
    exploited when ``topo.torus`` — the recovery path on a torus is
    never longer than on the equivalent mesh — and slow inter-pod links
    are avoided when the topology is tiered.

    Like XDMA's distributed-DMA re-configuration, this is purely an
    endpoint operation: the result is just a new cfg schedule for the
    survivors; nothing in the NoC changes.
    """
    order = [int(d) for d in order]
    dead = set(normalize_failed(failed))
    missing = dead - set(order)
    if missing:
        raise ValueError(
            f"failed node(s) {sorted(missing)} are not chain members"
        )
    i = min(order.index(f) for f in dead)
    prefix = order[:i]
    suffix = [d for d in order[i + 1 :] if d not in dead]
    if not suffix:
        return prefix
    tail = prefix[-1] if prefix else source
    rescheduled = SCHEDULERS[scheduler](topo, suffix, tail)
    if chain_total_cost(topo, rescheduled, tail) <= chain_total_cost(
        topo, suffix, tail
    ):
        return prefix + rescheduled
    return prefix + suffix
