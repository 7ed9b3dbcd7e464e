"""Distribution-layer collectives for the port: the host-side
multi-chain broadcast plan.

:class:`MultiChainPlan` is ``repro.parallel.collectives.MultiChainPlan``
minus its ``broadcast`` method, which needs the in-graph chain executor
(a later slice). The serving runtime holds one plan for its replica
set: weight refresh and KV multicast stream down its sub-chains, and
elastic scale-down re-forms it around lost replicas.
"""

from __future__ import annotations

from repro_torch.core.scheduling import (
    FailureSpec,
    normalize_failed,
    partition_schedule,
    reform_chain,
)
from repro_torch.core.simulator import SourceFailedError
from repro_torch.core.topology import MeshTopology


class MultiChainPlan:
    """Host-side multi-chain broadcast plan with endpoint-only
    re-forming.

    The destination set is partitioned into K link-disjoint-preferring
    sub-chains (``core.scheduling.partition_schedule``). On a node
    failure, :meth:`reform` splices the dead member(s) — one node or a
    concurrent failure *set* — out of their sub-chains and re-orders
    each orphaned suffix (``core.scheduling.reform_chain``), so the next
    transfer is the degraded multicast over the survivors.
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
