"""Data pipeline of the port (numpy sources, background prefetch)."""

from .pipeline import MarkovSource, Prefetcher, UniformSource, make_device_placer, rank_slice

__all__ = ["MarkovSource", "Prefetcher", "UniformSource", "make_device_placer", "rank_slice"]
