"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Asking for a CUDA device on a machine without one
    raises — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
