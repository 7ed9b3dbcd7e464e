"""Pin the top-k routing of the port's MoE calls, for comparisons of two
runs that should differ only below the router.

Top-k routing is discontinuous: where two router probabilities are
within the rounding noise of the hidden state, two runs that round the
layers below differently (XLA against PyTorch, or the flash kernel
against the reference attention) can pick different experts, and the
token's output then moves by O(1). :func:`recorded_routing` records the
experts every MoE call of one run picks; :func:`routing_as` makes the
MoE calls of another run take those experts, with their own
probabilities gathered at them (so grads still reach the router). Both
patch ``repro_torch.models.moe._route`` while they are open.

Imports only torch and the port: ``chip_smoke.py`` uses it on the card.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models import moe as M


@contextlib.contextmanager
def _patched_route(fn):
    route = M._route
    M._route = fn
    try:
        yield
    finally:
        M._route = route


@contextlib.contextmanager
def recorded_routing():
    """Yield a list that gets the top-k experts of every MoE call made
    inside, in call order."""
    route, seen = M._route, []

    def record(xf, router, k):
        out = route(xf, router, k)
        seen.append(out[2])
        return out

    with _patched_route(record):
        yield seen


@contextlib.contextmanager
def routing_as(choices):
    """Route the MoE calls made inside with the next of ``choices`` (one
    top-k expert tensor per call, in call order) instead of their own
    top-k. Yields a list that gets, per call, a bool tensor per token:
    whether the call's own top-k set differs from the one it was given."""
    route, calls, flips = M._route, iter(choices), []

    def following(xf, router, k):
        probs, _, own = route(xf, router, k)
        top_e = next(calls).to(own.device, torch.long).reshape(own.shape)
        flips.append((own.sort(-1)[0] != top_e.sort(-1)[0]).any(-1).reshape(-1))
        top_p = probs.gather(-1, top_e)
        return probs, top_p / top_p.sum(-1, keepdim=True), top_e

    with _patched_route(following):
        yield flips
