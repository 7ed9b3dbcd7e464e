"""Fault-tolerant training loop: restart from checkpoint — the
port of ``repro.runtime.failure`` (the same loop; it only moves tensors
through the checkpoint manager it is given).

``resilient_loop`` wraps a step function with (a) periodic async
checkpointing, (b) crash recovery — any exception classified as a
*node failure* rolls the loop back to the latest complete checkpoint
and replays (the data pipeline is counter-based, so replay is exact),
(c) a bounded restart budget. :class:`FaultInjector` drives the tests.

Chain re-forming (Torrent fault tolerance): a
:class:`SimulatedNodeFailure` that names the dead member(s) can be
handled *without* rolling back — pass ``reform_fn`` (e.g.
``parallel.collectives.MultiChainPlan.reform``) and the loop re-forms
the Chainwrite schedule around the dead members and retries the same
step with the live state. Recovery is purely an endpoint-side re-cfg
(no NoC change; the one recovery schedule is a
``core.program.plan_recovery`` ChainProgram), so only the failed
members' sub-chains pay; the checkpoint rollback path remains the
fallback for anonymous failures or when re-forming declines.

**The failure-set API.** Failures are *sets*, everywhere: a
:class:`SimulatedNodeFailure` carries ``nodes`` — a tuple of every
member that died in the event (``node`` remains as the single-failure
convenience and aliases ``nodes[0]``); ``reform_fn`` receives the
single node for a lone failure (pre-set compatibility) or the whole
tuple for a concurrent event, and every consumer down the stack
(``MultiChainPlan.reform``, ``scheduling.reform_chain``,
``chainwrite.degraded_chains``, ``simulator.chain_recovery_latency``,
``MultiChainTask.inject_failure`` accumulation) accepts one id or an
iterable via ``scheduling.normalize_failed``. Losing the *source* is
not a member failure: re-forming cannot recover it (nobody upstream
banked the payload), so ``reform_fn`` raising
:class:`SourceFailedError` (re-exported from ``core.simulator``)
makes the loop fall back to checkpoint rollback instead of retrying.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from repro_torch.core.simulator import SourceFailedError

log = logging.getLogger("repro_torch.runtime")

__all__ = [
    "FaultInjector",
    "LoopResult",
    "SimulatedNodeFailure",
    "SourceFailedError",
    "resilient_loop",
]


class SimulatedNodeFailure(RuntimeError):
    """One or more nodes died mid-step. ``nodes`` (when known)
    identifies every dead chain member of the event so the runtime can
    re-form around the set instead of restarting from a checkpoint;
    ``node`` is the single-failure convenience alias (the first of
    ``nodes``)."""

    def __init__(
        self,
        message: str = "",
        node: int | None = None,
        nodes: tuple[int, ...] | None = None,
    ):
        super().__init__(message)
        if nodes is None:
            nodes = () if node is None else (int(node),)
        else:
            nodes = tuple(int(n) for n in nodes)
            if node is not None and int(node) not in nodes:
                nodes = (int(node),) + nodes
        self.nodes: tuple[int, ...] = nodes
        self.node: int | None = nodes[0] if nodes else None


class FaultInjector:
    """Raises SimulatedNodeFailure at the scheduled steps (once each).

    ``node`` / ``nodes`` attribute the injected failures to specific
    chain members so the re-forming path can be driven in tests
    (``nodes`` injects a concurrent multi-member failure event).
    """

    def __init__(
        self,
        fail_at: tuple[int, ...] = (),
        node: int | None = None,
        nodes: tuple[int, ...] | None = None,
    ):
        self.pending = set(fail_at)
        self.node = node
        self.nodes = nodes

    def maybe_fail(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise SimulatedNodeFailure(
                f"injected failure at step {step}",
                node=self.node,
                nodes=self.nodes,
            )


@dataclasses.dataclass
class LoopResult:
    final_step: int
    restarts: int
    metrics_history: list[dict]
    reforms: int = 0


def resilient_loop(
    *,
    state: Any,  # (params, opt_state) pytree
    step_fn: Callable[[Any, int], tuple[Any, dict]],
    num_steps: int,
    ckpt,  # CheckpointManager
    ckpt_every: int = 50,
    max_restarts: int = 10,
    start_step: int = 0,
    restore_fn: Callable[[int, Any], Any] | None = None,
    on_step: Callable[[int, dict], None] | None = None,
    reform_fn: Callable[..., bool] | None = None,
) -> tuple[Any, LoopResult]:
    """Run ``step_fn`` for ``num_steps`` with checkpoint/restart.

    ``restore_fn(step, like_state) -> state`` defaults to
    ``ckpt.restore``; override for elastic restores.

    ``reform_fn(nodes) -> bool`` handles failures that name dead chain
    members (one node id for a lone failure, the tuple for a
    concurrent event): return True to signal the Chainwrite schedule
    was re-formed around them — the loop then retries the *same* step
    with the live state (no rollback, no replay). Returning False, an
    anonymous failure, or ``reform_fn`` raising
    :class:`SourceFailedError` (the dead node was the chain *source* —
    total loss, nothing banked downstream of nothing) falls back to
    the checkpoint-restart path. Re-forms and restarts share the
    ``max_restarts`` budget.
    """
    if restore_fn is None:
        restore_fn = lambda s, like: ckpt.restore(s, like)

    restarts = 0
    reforms = 0
    history: list[dict] = []
    step = start_step
    ckpt.save(step, state, blocking=True)  # step-0 baseline

    while step < num_steps:
        try:
            state, metrics = step_fn(state, step)
            step += 1
            history.append(metrics)
            if on_step is not None:
                on_step(step, metrics)
            if step % ckpt_every == 0:
                ckpt.save(step, state)
        except SimulatedNodeFailure as e:
            nodes = getattr(e, "nodes", ()) or ()
            if not nodes and getattr(e, "node", None) is not None:
                nodes = (e.node,)  # pre-failure-set exception classes
            reformed = False
            if reform_fn is not None and nodes:
                spec = nodes[0] if len(nodes) == 1 else nodes
                try:
                    reformed = bool(reform_fn(spec))
                except SourceFailedError as total_loss:
                    log.warning(
                        "source died (%s) -> rollback, not re-form",
                        total_loss,
                    )
            if reformed:
                reforms += 1
                if restarts + reforms > max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                log.warning(
                    "node(s) %s failed at step %d -> chain re-formed, retrying",
                    list(nodes), step,
                )
                continue  # state is intact: retry the same step
            restarts += 1
            if restarts + reforms > max_restarts:
                raise RuntimeError("restart budget exhausted") from e
            ckpt.wait()  # let in-flight saves land
            latest = ckpt.latest_step()
            log.warning("node failure at step %d -> restoring step %s", step, latest)
            state = restore_fn(latest, state)
            step = latest
    ckpt.save(step, state, blocking=True)
    return state, LoopResult(step, restarts, history, reforms)
