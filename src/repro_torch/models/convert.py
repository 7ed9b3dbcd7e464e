"""Carry weights across from the JAX package.

``params_from_numpy`` takes a param tree of numpy arrays — the JAX
package's params after ``jax.device_get`` — and returns the port's
params: the same nesting (dicts, lists) with every array a tensor on
``device``. Both packages lay out params identically (stacked layer
groups, ``(in, out)`` matmul weights), so the conversion is a plain map.
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


def params_from_numpy(tree, device="cuda"):
    """The port's params from a (nested dict/list) tree of numpy arrays."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return _tensor(tree, dev)
