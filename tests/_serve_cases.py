"""The greedy-token check shared by the tests that hold a port
``Server`` against a JAX ``Server`` with the same weights and requests
(``tests/test_torch_serve.py``, ``tests/test_torch_examples.py``).

The two frameworks round bf16 at different places, so their logits
agree within ``LOGIT_REL`` of their scale, not bit for bit: where a
greedy token differs, JAX's own top-2 margin at that step must be
within twice that tolerance (the two candidates were tied at bf16
precision).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from repro.models import transformer as JT

LOGIT_REL = 5e-2


def jax_logits_along_serve_path(jserver, jr, k, prefix_len):
    """JAX's logits for request ``jr``'s ``k``-th output token, computed
    one row at a time along the path its server took: a miss prefills
    the prompt; a prefix hit prefills the seeded prefix and feeds the
    rest of the prompt through decode steps; then ``jr.out[:k]`` are fed
    through decode steps. (A full prefill of prompt and outputs is not
    that path for a MoE arch: its capacity is computed over the whole
    sequence, so it can drop assignments the decode steps keep.)"""
    cfg, params = jserver.cfg, jserver.params
    prompt = np.asarray(jr.prompt, np.int32)
    seed = (min(prefix_len, prompt.size - 1) if jr.prefix_hit else prompt.size)
    logits, cache = JT.prefill(params, cfg, {"tokens": jnp.asarray(prompt[:seed])[None]},
                               jserver.sc.max_seq)
    fed = list(prompt[seed:]) + list(jr.out[:k])
    for i, t in enumerate(fed):
        logits, cache = JT.decode_step(params, cfg, jnp.asarray([t], jnp.int32),
                                       jnp.asarray([seed + i], jnp.int32), cache)
    return np.asarray(logits[0])


def check_tokens(jserver, jreqs, treqs, prefix_len):
    """Same greedy tokens, or a divergence where JAX itself had a tie."""
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.out) == len(jr.out) and tr.prefix_hit == jr.prefix_hit
        diff = [k for k, (a, b) in enumerate(zip(jr.out, tr.out)) if a != b]
        if not diff:
            continue
        k = diff[0]
        top = np.sort(jax_logits_along_serve_path(jserver, jr, k, prefix_len))[::-1]
        assert top[0] - top[1] <= 2 * LOGIT_REL * np.abs(top).max(), (jr.rid, k, top[:2])
