"""Hand-written Hopper (sm_90a) kernels for the compute hot spots, each
beside its plain PyTorch twin:

* :mod:`.relayout`        — DSE blocked-layout transform (paper P1/P2),
  ``csrc/relayout.cu``.
* :mod:`.flash_attention` — blockwise attention (prefill hot spot),
  causal + sliding-window, GQA, every head dim a multiple of 8 up to
  256, on the tensor cores: ``csrc/flash_attention_sm90.cu`` for
  bf16/f16 and ``csrc/flash_attention_f32_sm90.cu`` for f32 (3xTF32; a
  cluster of two blocks above D = 128).

A wrapper runs the plain twin only for a CPU tensor; for a CUDA tensor
it launches the kernel (built by :mod:`._build` at first use) or raises.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches`` (flash attention also per route, in
``flash_attention.launches_by_route``).
"""
