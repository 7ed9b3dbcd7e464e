"""Torrent core — the paper's contribution, for PyTorch.

* :mod:`.topology`   — weighted link-graph topologies: uniform 2-D
  mesh/torus + XY routing, 2-tier pod meshes, and the explicit
  LinkGraph oracle.
* :mod:`.scheduling` — Chainwrite sequence schedulers (Alg. 1 greedy,
  open-path TSP) and weighted hop/tier-crossing accounting.
* :mod:`.program`    — the ChainProgram schedule IR + ``plan_*``
  planners.
* :mod:`.simulator`  — cycle-level NoC model, driving the IR via
  ``program_latency``/``program_wire_bytes``.
* :mod:`.chaintask`  — host-side four-phase orchestration (Fig. 4) with
  the DATA phase as device-to-device copies of ``uint8`` tensors.

The first four use only the standard library and are byte-identical
copies of ``repro.core``'s (pinned by ``tests/test_torch_core.py``), so
both packages plan and price every transfer alike. The in-graph program
executor (``repro.core.chainwrite``) has no counterpart here yet.
"""

from .chaintask import (
    AffinePattern,
    ChainConfig,
    ChainTask,
    MultiChainTask,
    Phase,
)
from .program import (
    ChainProgram,
    Step,
    plan_all_gather,
    plan_all_reduce,
    plan_all_to_all,
    plan_broadcast,
    plan_reduce_scatter,
    program_wire_bytes,
    tier_crossing_stats,
)
from .scheduling import (
    SCHEDULERS,
    brute_force_schedule,
    chain_slow_links,
    chain_tier_crossings,
    chain_total_cost,
    chain_total_hops,
    greedy_schedule,
    multicast_total_hops,
    naive_schedule,
    partition_balance_slack,
    partition_schedule,
    partition_tier_crossings,
    partition_total_hops,
    reform_chain,
    tsp_schedule,
    unicast_total_hops,
)
from .simulator import (
    DEFAULT_PARAMS,
    SimParams,
    SourceFailedError,
    all_reduce_latency,
    all_reduce_wire_bytes,
    chain_recovery_latency,
    chainwrite_latency,
    choose_num_chains,
    config_overhead_per_destination,
    eta_p2mp,
    multi_chain_latency,
    multicast_latency,
    p2mp_efficiency_point,
    p2p_latency,
    plan_ring_collective,
    program_latency,
    unicast_latency,
)
from .topology import (
    LinkAttrs,
    LinkGraph,
    MeshTopology,
    TieredMeshTopology,
    parse_topology_spec,
)

__all__ = [
    "AffinePattern",
    "ChainConfig",
    "ChainProgram",
    "ChainTask",
    "DEFAULT_PARAMS",
    "LinkAttrs",
    "LinkGraph",
    "MeshTopology",
    "MultiChainTask",
    "Phase",
    "SCHEDULERS",
    "SimParams",
    "SourceFailedError",
    "Step",
    "TieredMeshTopology",
    "all_reduce_latency",
    "all_reduce_wire_bytes",
    "brute_force_schedule",
    "chain_recovery_latency",
    "chain_slow_links",
    "chain_tier_crossings",
    "chain_total_cost",
    "chain_total_hops",
    "chainwrite_latency",
    "choose_num_chains",
    "config_overhead_per_destination",
    "eta_p2mp",
    "greedy_schedule",
    "multi_chain_latency",
    "multicast_latency",
    "multicast_total_hops",
    "naive_schedule",
    "p2mp_efficiency_point",
    "p2p_latency",
    "parse_topology_spec",
    "partition_balance_slack",
    "partition_schedule",
    "partition_tier_crossings",
    "partition_total_hops",
    "plan_all_gather",
    "plan_all_reduce",
    "plan_all_to_all",
    "plan_broadcast",
    "plan_reduce_scatter",
    "plan_ring_collective",
    "program_latency",
    "program_wire_bytes",
    "reform_chain",
    "tier_crossing_stats",
    "tsp_schedule",
    "unicast_latency",
    "unicast_total_hops",
]
