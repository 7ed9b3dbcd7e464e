"""Record the JAX package's MoE routing, to pin the port's to it
(``tests/_moe_routing.routing_as``).

Top-k routing is discontinuous: where two router probabilities are
within the bf16 noise of the hidden state (XLA and PyTorch round the
layers below differently), the packages can pick different experts,
and the token's output then moves by O(1). So the model-level tests
route the port's MoE calls as JAX routed them (the port's
probabilities, gathered at JAX's experts, so grads reach the router),
and hold the port's own choices to JAX's except at such near ties.
Routing on identical inputs is exact
(``tests/test_torch_moe.py::test_single_device_paths_match_jax``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import moe as JM

NEAR_TIE = 1e-2  # probability margin; flips seen on the smoke models: <= 1.5e-3


def record_jax_routing(monkeypatch) -> list:
    """JAX's (probs, top-k experts) of every flat-path MoE call, in
    call order (``monkeypatch`` undoes the patch)."""
    seen = []
    flat = JM._moe_apply_flat

    def recording(params, x, cfg):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                               @ params["router"], axis=-1)
        jax.debug.callback(lambda p, e: seen.append((np.asarray(p), np.asarray(e))),
                           probs, jax.lax.top_k(probs, cfg.moe_top_k)[1], ordered=True)
        return flat(params, x, cfg)

    monkeypatch.setattr(JM, "_moe_apply_flat", recording)
    return seen


def flip_margins(seen: list, flips: list) -> list:
    """JAX's margin (k-th minus (k+1)-th probability) at every decision
    where the port's own top-k set differs from JAX's."""
    out = []
    for (jprobs, jtop), differs in zip(seen, flips, strict=True):
        k = jtop.shape[-1]
        ranked = np.sort(jprobs.reshape(-1, jprobs.shape[-1]), -1)[:, ::-1]
        d = differs.numpy()
        out.extend(ranked[d, k - 1] - ranked[d, k])
    return out
