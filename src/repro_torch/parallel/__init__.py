"""Distribution layer of the port (so far: the multi-chain broadcast plan)."""

from .collectives import MultiChainPlan

__all__ = ["MultiChainPlan"]
