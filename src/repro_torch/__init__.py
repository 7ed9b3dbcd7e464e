"""Torrent on PyTorch + hand-written Hopper kernels.

The PyTorch port of the JAX package ``repro``, laid out the same way
(``core/``, ``kernels/``, ``models/``, ``launch/``, ``parallel/``,
``runtime/``, ``configs/``). It imports ``torch`` and numpy only. Entry
points take an explicit ``device`` that defaults to ``"cuda"``; with no
card they raise unless the caller asks for ``"cpu"``. On a CPU tensor
every kernel wrapper runs its plain PyTorch twin; on a CUDA tensor it
launches the kernel (built from ``csrc/`` with ``nvcc`` at first use).
"""
