"""Hand-written Hopper (sm_90a) kernels for the compute hot spots, each
beside its plain PyTorch twin:

* :mod:`.relayout`        — DSE blocked-layout transform (paper P1/P2),
  ``csrc/relayout.cu``.
* :mod:`.flash_attention` — blockwise attention (prefill hot spot),
  causal + sliding-window, GQA; ``csrc/flash_attention.cu``.

A wrapper runs the plain twin only for a CPU tensor; for a CUDA tensor
it launches the kernel (built by :mod:`._build` at first use) or raises.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``.
"""
