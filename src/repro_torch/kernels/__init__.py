"""Hand-written Hopper (sm_90a) kernels for the compute hot spots, each
beside its plain PyTorch twin:

* :mod:`.relayout`        — DSE blocked-layout transform (paper P1/P2),
  ``csrc/relayout.cu``.
* :mod:`.flash_attention` — blockwise attention (prefill hot spot),
  causal + sliding-window, GQA; ``csrc/flash_attention_sm90.cu`` on the
  tensor cores for bf16/f16, ``csrc/flash_attention.cu`` for f32 and
  head dims that are not a multiple of 16.

A wrapper runs the plain twin only for a CPU tensor; for a CUDA tensor
it launches the kernel (built by :mod:`._build` at first use) or raises.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches`` (flash attention also per route, in
``flash_attention.launches_by_route``).
"""
