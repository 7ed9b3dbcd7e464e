"""Host-side four-phase Chainwrite orchestration (paper §III-A/B, Fig. 4).

The PyTorch counterpart of ``repro.core.chaintask``: the same
:class:`ChainTask` / :class:`MultiChainTask` protocol and cycle ledgers
(integer-identical — both price through the shared
:mod:`.simulator` copy), with the payload a tensor on its own device.

* :class:`ChainConfig` — the cfg packet of Fig. 4(c): chain linkage
  (prev/next node), transfer geometry (AXI size field) and the
  ND-affine access pattern for the DSE (field F).
* :class:`ChainTask` — a P2MP task driven through the four phases
  CFG_DISPATCH → GRANT_BACKPROP → DATA → FINISH_BACKPROP, with a
  per-phase cycle ledger.
* :class:`MultiChainTask` — K concurrent sub-chains from one initiator,
  with a merged ledger (the concurrent critical path), per-chain
  ledgers, and failure injection that charges recovery only to the
  affected sub-chains.

The DATA phase is a store-and-forward through per-node buffers: every
member receives its own device-to-device copy of the gathered stream.
The identity access pattern is taken as the contiguous payload itself
(the same bytes as the gather, without an int64 index per byte); every
other pattern goes through the general gather.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Sequence

import torch

from . import simulator
from .scheduling import SCHEDULERS, partition_schedule
from .topology import MeshTopology


class Phase(enum.Enum):
    IDLE = "idle"
    CFG_DISPATCH = "cfg_dispatch"
    GRANT_BACKPROP = "grant_backprop"
    DATA = "data"
    FINISH_BACKPROP = "finish_backprop"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class AffinePattern:
    """ND-affine access pattern (cfg field F — the DSE program).

    Reads ``prod(bounds)`` elements at ``base + sum_i idx_i*strides_i``.
    """

    base: int
    bounds: tuple[int, ...]
    strides: tuple[int, ...]

    def indices(self, device: torch.device | str = "cpu") -> torch.Tensor:
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for b, s in zip(self.bounds, self.strides):
            idx = idx[..., None] + torch.arange(b, dtype=torch.int64, device=device) * s
        return (self.base + idx).reshape(-1)

    def is_identity(self, size: int) -> bool:
        """True when the pattern reads elements ``0..size-1`` in order."""
        return (self.base, tuple(self.bounds), tuple(self.strides)) == (0, (size,), (1,))


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """One cfg frame body (Fig. 4(c) fields A–F)."""

    node: int  # this Torrent's node id
    prev_node: int | None  # field A/B: upstream link (None = initiator)
    next_node: int | None  # field C/D: downstream link (None = tail)
    size_bytes: int  # field E: AXI transfer size
    pattern: AffinePattern  # field F: DSE access pattern


Transport = Callable[[int, int, torch.Tensor], None]


class ChainTask:
    """A single P2MP Chainwrite task, orchestrated in four phases."""

    def __init__(
        self,
        topo: MeshTopology,
        source: int,
        destinations: Sequence[int],
        payload: torch.Tensor,
        *,
        scheduler: str = "greedy",
        order: Sequence[int] | None = None,
        pattern: AffinePattern | None = None,
        sim_params: simulator.SimParams = simulator.DEFAULT_PARAMS,
    ) -> None:
        if len(set(destinations)) != len(destinations):
            raise ValueError("duplicate destinations")
        if source in destinations:
            raise ValueError("source cannot be a destination")
        self.topo = topo
        self.source = source
        self.payload = payload.contiguous()
        if order is not None:
            # Caller supplies a pre-computed traversal (e.g. one
            # sub-chain of a MultiChainTask partition).
            if sorted(order) != sorted(destinations):
                raise ValueError("order must permute the destinations")
            self.order = [int(d) for d in order]
        else:
            self.order = SCHEDULERS[scheduler](topo, list(destinations), source)
        self.scheduler = scheduler
        self.sim_params = sim_params
        self.pattern = pattern or AffinePattern(
            base=0, bounds=(self.payload.numel(),), strides=(1,)
        )
        self.phase = Phase.IDLE
        self.grants: set[int] = set()
        self.finishes: set[int] = set()
        self.node_buffers: dict[int, torch.Tensor] = {}
        self.cycle_ledger: dict[str, int] = {}

    # -- cfg packets (Fig. 4c) ----------------------------------------
    def configs(self) -> list[ChainConfig]:
        chain = [self.source] + list(self.order)
        cfgs = []
        for i, node in enumerate(chain):
            cfgs.append(
                ChainConfig(
                    node=node,
                    prev_node=chain[i - 1] if i > 0 else None,
                    next_node=chain[i + 1] if i + 1 < len(chain) else None,
                    size_bytes=self.payload.nbytes,
                    pattern=self.pattern,
                )
            )
        return cfgs

    def _gather(self) -> torch.Tensor:
        """The DSE read of the payload through the access pattern."""
        flat = self.payload.reshape(-1)
        if self.pattern.is_identity(flat.numel()):
            return flat
        return flat[self.pattern.indices(flat.device) % flat.numel()]

    # -- four-phase execution ------------------------------------------
    def run(self, transport: Transport | None = None) -> dict[int, torch.Tensor]:
        """Drive all four phases; returns the per-destination buffers."""
        p = self.sim_params
        chain = [self.source] + list(self.order)
        n = len(self.order)

        # Phase 1 — cfg dispatch (initiator -> all members, parallel).
        self.phase = Phase.CFG_DISPATCH
        far = max(self.topo.distance(self.source, d) for d in self.order)
        self.cycle_ledger["cfg"] = (
            p.dma_setup_cc + n * p.cfg_inject_cc + far * p.router_cc + p.cfg_proc_cc
        )

        # Phase 2 — grant backward propagation (tail -> head). A node
        # forwards the grant only once it is ready (models Fig. 4(b)).
        self.phase = Phase.GRANT_BACKPROP
        for node in reversed(chain[1:]):
            self.grants.add(node)
        hops = sum(
            self.topo.distance(a, b) for a, b in zip(chain, chain[1:])
        )
        self.cycle_ledger["grant"] = hops * p.router_cc + n * p.grant_fwd_cc

        # Phase 3 — data: store-and-forward through every member, one
        # device-to-device copy per member.
        self.phase = Phase.DATA
        gathered = self._gather()
        for prev, node in zip(chain, chain[1:]):
            if transport is not None:
                transport(prev, node, gathered)
            self.node_buffers[node] = gathered.clone()
        self.cycle_ledger["data"] = (
            hops * p.router_cc
            + n * p.sf_fill_cc
            + simulator._ceil_div(gathered.nbytes, simulator._effective_bw(p, 1))
        )

        # Phase 4 — finish backward propagation (tail -> head).
        self.phase = Phase.FINISH_BACKPROP
        for node in reversed(chain[1:]):
            self.finishes.add(node)
        self.cycle_ledger["finish"] = hops * p.router_cc + n * p.finish_fwd_cc

        self.phase = Phase.DONE
        self.cycle_ledger["total"] = sum(
            self.cycle_ledger[k] for k in ("cfg", "grant", "data", "finish")
        )
        return self.node_buffers

    # -- cost predictions (runtime policy) ------------------------------
    def predicted_cycles(self) -> int:
        return simulator.chainwrite_latency(
            self.topo, self.source, self.order, self.payload.nbytes, self.sim_params
        )

    def unicast_cycles(self) -> int:
        return simulator.unicast_latency(
            self.topo, self.source, self.order, self.payload.nbytes, self.sim_params
        )

    def speedup_vs_unicast(self) -> float:
        return self.unicast_cycles() / max(1, self.predicted_cycles())


class MultiChainTask:
    """K concurrent Chainwrite sub-chains from one initiator.

    The destination set is split by ``scheduling.partition_schedule``
    (``num_chains=None`` -> K chosen by the calibrated cycle model via
    ``simulator.choose_num_chains``); one :class:`ChainTask` drives each
    sub-chain through its four phases. The merged ``cycle_ledger``
    models the shared cfg-inject port: per-phase entries are the
    critical (max-over-chains) values with cfg serialization applied,
    and ``total`` is ``simulator.multi_chain_latency`` — the concurrent
    critical path.
    """

    def __init__(
        self,
        topo: MeshTopology,
        source: int,
        destinations: Sequence[int],
        payload: torch.Tensor,
        *,
        num_chains: int | None = None,
        chains: Sequence[Sequence[int]] | None = None,
        scheduler: str = "tsp",
        pattern: AffinePattern | None = None,
        sim_params: simulator.SimParams = simulator.DEFAULT_PARAMS,
    ) -> None:
        if len(set(destinations)) != len(destinations):
            raise ValueError("duplicate destinations")
        if source in destinations:
            raise ValueError("source cannot be a destination")
        self.topo = topo
        self.source = source
        self.payload = payload.contiguous()
        self.sim_params = sim_params
        nbytes = self.payload.nbytes
        if chains is not None:
            # Caller supplies the partition (e.g. a MultiChainPlan's
            # possibly re-formed schedule); must cover the destinations.
            chains = [[int(d) for d in c] for c in chains if len(c)]
            flat = [d for c in chains for d in c]
            if sorted(flat) != sorted(int(d) for d in destinations):
                raise ValueError("chains must partition the destinations")
            self.chains = chains
            self.num_chains = len(chains)
        elif num_chains is None:
            self.num_chains, self.chains = simulator.choose_num_chains(
                topo, source, list(destinations), nbytes,
                scheduler=scheduler, p=sim_params,
            )
        else:
            self.chains = partition_schedule(
                topo, list(destinations), source,
                num_chains=num_chains, scheduler=scheduler,
            )
            self.num_chains = len(self.chains)
        self.scheduler = scheduler
        self.pattern = pattern
        self.tasks = [
            ChainTask(
                topo, source, list(chain), self.payload,
                order=chain, pattern=pattern, sim_params=sim_params,
            )
            for chain in self.chains
        ]
        self.phase = Phase.IDLE
        self.failed_nodes: list[int] = []
        self.reformed_chains: list[list[int]] | None = None
        self.node_buffers: dict[int, torch.Tensor] = {}
        self.cycle_ledger: dict[str, int] = {}
        self.per_chain_ledgers: list[dict[str, int]] = []

    @property
    def failed_node(self) -> int | None:
        """The sole injected failure; raises when several accumulated."""
        if not self.failed_nodes:
            return None
        if len(self.failed_nodes) > 1:
            raise RuntimeError(
                f"multiple failures injected {self.failed_nodes}; "
                "use failed_nodes"
            )
        return self.failed_nodes[0]

    def configs(self) -> list[ChainConfig]:
        """All chains' cfg frames in cfg-inject (serialization) order."""
        return [cfg for task in self.tasks for cfg in task.configs()]

    # -- failure injection (fault-tolerance hook) ----------------------
    def inject_failure(self, node: int) -> None:
        """Mark chain member ``node`` as dead before :meth:`run`.

        May be called several times to accumulate a *set* of
        concurrently dead members. Injecting the same node twice, or a
        node that is not a chain member, raises.
        """
        if self.phase is not Phase.IDLE:
            raise RuntimeError("failure must be injected before run()")
        node = int(node)
        if node in self.failed_nodes:
            raise ValueError(f"node {node} already injected as failed")
        if not any(node in chain for chain in self.chains):
            raise ValueError(f"node {node} is not a chain member")
        self.failed_nodes.append(node)

    def run(self, transport: Transport | None = None) -> dict[int, torch.Tensor]:
        """Drive every sub-chain; returns the merged destination buffers.

        With injected failures every affected sub-chain is re-formed
        and re-driven so every *surviving* destination still receives
        the payload; the failed nodes get no buffer.
        """
        self.phase = Phase.CFG_DISPATCH
        nbytes = self.payload.nbytes
        recoveries: list[dict[str, object]] = []
        if not self.failed_nodes:
            detail = simulator.multi_chain_latency(
                self.topo, self.source, self.chains, nbytes,
                self.sim_params, detail=True,
            )
            per_phase = detail["per_phase"]
            total = detail["total"]
            for task in self.tasks:
                self.node_buffers.update(task.run(transport))
        else:
            rec_detail = simulator.chain_recovery_latency(
                self.topo, self.source, self.chains, set(self.failed_nodes),
                nbytes, self.sim_params,
                scheduler=self.scheduler, detail=True,
            )
            recoveries = rec_detail["recoveries"]
            per_phase = rec_detail["per_phase"]  # failure-free split
            total = rec_detail["total"]  # already includes recovery
            affected = {r["chain"]: r for r in recoveries}
            for i, task in enumerate(self.tasks):
                if i not in affected:
                    self.node_buffers.update(task.run(transport))
            self.reformed_chains = [
                list(affected[i]["reformed"]) if i in affected else list(c)
                for i, c in enumerate(self.chains)
            ]
            for rec in recoveries:
                reformed = list(rec["reformed"])
                if reformed:
                    degraded = ChainTask(
                        self.topo, self.source, reformed, self.payload,
                        order=reformed, pattern=self.pattern,
                        sim_params=self.sim_params,
                    )
                    self.node_buffers.update(degraded.run(transport))
        self.phase = Phase.DONE

        # Per-sub-chain ledgers: cfg includes the shared-port stagger;
        # recovery cycles land only on the failed members' chains.
        self.per_chain_ledgers = [
            {
                "cfg": c, "grant": g, "data": d, "finish": f,
                "recovery": 0, "total": c + g + d + f,
            }
            for (c, g, d, f) in per_phase
        ]
        for rec in recoveries:
            lg = self.per_chain_ledgers[rec["chain"]]
            lg["recovery"] = rec["recovery_cc"]
            lg["total"] += rec["recovery_cc"]

        # Merged ledger: the concurrent phases take the max over
        # chains; total is the true critical path.
        phases = per_phase or [(0, 0, 0, 0)]  # empty dest set
        self.cycle_ledger = {
            "cfg": max(ph[0] for ph in phases),
            "grant": max(ph[1] for ph in phases),
            "data": max(ph[2] for ph in phases),
            "finish": max(ph[3] for ph in phases),
            "total": total,
        }
        if recoveries:
            # concurrent per-chain recoveries: the critical-path charge
            self.cycle_ledger["recovery"] = max(
                r["recovery_cc"] for r in recoveries
            )
        return self.node_buffers

    # -- cost predictions (runtime policy) ------------------------------
    def predicted_cycles(self) -> int:
        return simulator.multi_chain_latency(
            self.topo, self.source, self.chains, self.payload.nbytes,
            self.sim_params,
        )

    def single_chain_cycles(self, scheduler: str = "tsp") -> int:
        order = SCHEDULERS[scheduler](
            self.topo, [d for c in self.chains for d in c], self.source
        )
        return simulator.chainwrite_latency(
            self.topo, self.source, order, self.payload.nbytes, self.sim_params
        )

    def speedup_vs_single_chain(self) -> float:
        return self.single_chain_cycles() / max(1, self.predicted_cycles())

    def unicast_cycles(self) -> int:
        return simulator.unicast_latency(
            self.topo, self.source, [d for c in self.chains for d in c],
            self.payload.nbytes, self.sim_params,
        )

    def speedup_vs_unicast(self) -> float:
        return self.unicast_cycles() / max(1, self.predicted_cycles())
