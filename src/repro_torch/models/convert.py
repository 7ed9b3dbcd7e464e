"""Carry weights and training state across from the JAX package.

``params_from_numpy`` takes a param tree of numpy arrays — the JAX
package's params after ``jax.device_get`` — and returns the port's
params: the same nesting (dicts, lists) with every array a tensor on
``device``. Both packages lay out params identically (stacked layer
groups, ``(in, out)`` matmul weights), so the conversion is a plain map.
The same map carries the rest of a training state — the AdamW state
(``mu``, ``nu`` and the 0-dim int32 ``step``) and the error-feedback
residuals — so both packages can start from identical state. With
``specs`` and a ``mesh`` (tensor parallelism) a rank takes its shards of
the logical arrays (``parallel.sharding.shard_tree``), so both packages
are fed the same logical weights at any TP size.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: device_get may hand out read-only arrays
    if a.dtype.name == "bfloat16":  # numpy's bf16 extension type
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16
        ).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda", *, specs=None, mesh=None):
    """The port's params (or any training-state tree) from a nested
    dict/list tree of numpy arrays; 0-dim arrays become 0-dim tensors.
    With ``specs`` (a matching tree of ``PartitionSpec``s) and ``mesh``,
    this rank's shard of each array."""
    if specs is not None:
        from repro_torch.parallel.sharding import shard_tree

        tree = shard_tree(tree, specs, mesh)
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return _tensor(tree, dev)

