#!/usr/bin/env python3
"""Run the PyTorch port's serving, decoding and training paths on one
NVIDIA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit; build every CUDA source under
   ``src/repro_torch/csrc`` with ``nvcc`` (one process per source, all
   at once) and print the build seconds and ptxas reports; count the
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the
   SASS of both tensor-core flash libraries (for the f32 one, the
   ``HGMMA`` with ``TF32`` operands and the cluster barrier
   ``UCGABAR_WAIT`` of its two-block instances), and fail if any count
   is 0;
2. relayout: each case through the route the wrapper names (``copy``,
   ``staged`` or ``direct``) against its plain twin, bit for bit: the
   paged-KV shape of the serve phase, the paper's layout pairs, two
   cases beyond the 50 MB L2 and a misaligned one; the SASS of
   ``relayout`` must hold no call of the 64-bit division subroutine.
   Each case is timed hot (back-to-back calls, data in L2) and cold
   (L2 flushed before every call); only the cold reading is held
   against the HBM bound, and one over 105% of it fails the run;
3. flash attention: each case through the kernel its route names
   (``wgmma`` for bf16/f16, ``tf32x3`` for f32, asserted per case)
   against the plain twin, within the stated tolerances: the serve
   phase's prefill shape and a 4096-token prefill, each in bf16 and in
   f32, the moe and hybrid serve phases' and the vlm decode phase's
   prefill shapes, f32 windowed cases, ragged, GQA and head-dim cases, and 4096-token
   prefills at head dims 40 (bf16, padded to 64), 192 and 256 (f32, on a
   cluster of two blocks). f32 cases print two bounds: the CUDA cores'
   f32 rate and the 3xTF32 rate (the TF32 tensor-core rate over the
   three products), held as ``bound_ms`` on the tf32x3 route;
4. f32 attention: ``flash_attention`` called on f32 inputs at yi-6b's
   heads (one block per q tile) and at D = 192 (a pair of blocks
   splitting the head dim), both on the 3xTF32 tensor-core kernel;
5. moe layer: one deepseek-moe-16b MoE layer at full width (64 routed
   experts top-6, d_ff 1408, 2 shared; random f32 params from a seed)
   on 8 virtual ranks of 512 bf16 tokens each: the flat and rowwise
   dispatch at ``capacity_factor=8`` against ``moe_ref`` (2e-2), the
   expert-parallel ``moe_apply_ep`` on the stacked view with K = 1 and
   K = 2 chain all-to-alls against the flat output (2e-2) and each
   other (bit for bit), on the int8 wire within 0.1 of ``moe_ref``'s
   scale; every call's executor wire bytes equal to
   ``program_wire_bytes`` of its three all-to-alls, the int8 token
   payload a quarter of its f32 size plus the scales; the flat and
   rowwise paths must make the host wait for the card no time (CUDA's
   sync debug mode, which must catch ``bincount``'s wait; EP's count is
   printed). Prints CUDA-event times of
   each path at capacity 8 and at the config's 1.25;
6. serve: a ``repro_torch.launch.serve.Server`` at yi-6b's full width
   (depth cut to 8 layers, ``attn_impl="flash"``, random weights from a
   seed): weight multicast, KV-prefix registration and multicast, then
   8 requests through ``run()``; both kernels' launch counters must move,
   every flash launch must take the ``wgmma`` route, every relayout
   launch the ``copy`` route, the caching allocator must not retry, and
   the flash prefill logits must agree with the reference attention's;
7. moe serve: the same traffic through a ``Server`` for deepseek-moe-16b
   at full width (MHA with 16 heads of 128, 64 routed experts top-6 and
   2 shared, vocab 102400; depth cut 28 -> 4 layers, 1 dense + 3 MoE),
   with the same checks; the reference prefill is routed as the flash
   one was, so the two differ only by their attention;
8. mla serve: the same traffic through a ``Server`` for
   deepseek-v2-lite-16b at full width (MLA: 16 heads, kv_lora_rank 512,
   qk_nope 128, qk_rope 64, v_head 128; the MoE of deepseek-moe-16b;
   depth cut 27 -> 4 layers, 1 dense + 3 MoE), with the same checks. Each
   serve path's kernel launches must be its entry of ``SERVE_PATHS``:
   MLA attends by einsums, so this one launches the relayout (4, copy)
   and no flash. Prints F per position of each KV multicast (MLA's
   compressed latent, ``4 x (512 + 64)``, against the MHA cache's
   ``4 x 2 x 16 x 128``), and the CUDA-event time of one decode step of
   the serve batch against a full cache (T = max_seq) with K/V recovered
   and with ``mla_absorb``, their logits within ``LOGIT_REL_TOL``;
9. ssm serve: the same traffic through a ``Server`` for mamba2-2.7b at
   full width and full depth (64 Mamba-2 SSD layers, d_inner 5120, 80
   heads of 64, state 128, no FFN, vocab 50280): ``register_prefix`` must
   refuse the prefix (a mamba cache has no per-position axis) and leave
   no entry, so all 8 prompts are misses; no kernel launches. Each mamba
   layer's chunked form against its recurrence on the same hidden states
   of a 200-token prompt (8 decode steps across a padded chunk boundary)
   within ``LOGIT_REL_TOL`` of its scale, and the whole model's last
   logits of ``prefill(200)`` against ``prefill(192)`` and 8 decode steps
   finite and within ``SSM_DRIFT_TOL``. Prints the CUDA-event time of one
   decode step of the serve batch and of one 512-token prefill;
10. hybrid serve: jamba-v0.1-52b at full width (Mamba layers with 8
   groups, GQA 32 heads / 8 KV heads of 128 with no positions, MoE 16
   experts top-2 of 14336 every other layer), depth cut 32 -> 5 layers
   (the shallowest cut that holds its GQA layer), one replica (the weight
   refresh must be a no-op): the prefix refused, 8 misses, flash launches
   (wgmma) for the refused prefix's prefill and each miss, the flash
   prefill logits against the reference's, and the mamba layers' two
   forms and times as in ssm serve;
11. vlm decode: qwen2-vl-7b at full width and full depth (28 layers,
   M-RoPE, 28 heads on 4 KV heads, 7.6 B params) through
   ``make_prefill_step`` and ``make_serve_step``: 4 prompts of 512 random
   embeddings at Qwen2-VL's image-then-text positions, then 32 greedy
   steps at a scalar position: 28 flash launches (wgmma), the flash
   logits against the reference attention's, the first decode step
   against a prefill of the S + 1 rows, the image layout against text
   positions, no host wait in a decode step;
12. audio decode: whisper-tiny at full size (1500 frames, reference
   attention): the flash encoder refused at 1500 frames as JAX refuses
   it, a prefill of 4 prompts of 64 tokens, 32 per-slot decode steps,
   each step's logits against the forward over the tokens so far, the
   scalar-position step equal to the per-slot one, no kernel launch;
13. audio train: whisper-tiny at full size through ``make_train_step``
   on 4 virtual DP ranks of 4 x 448 tokens and their frames, Torrent
   reduction (rs_ag, K = 2): the first batch's loss and grads of the
   4-rank reduction against one rank's on the whole batch (``TRAIN_*_TOL``;
   a quarter batch's grads must miss), then 6 exact and 6 int8 + EF
   steps: finite losses, the first within ``TRAIN_LOSS_REL_TOL`` of the
   one-rank loss, the last below the first, every param moved, wire
   bytes equal to the byte model and the int8 payload a quarter of the
   exact one plus its scales, no kernel launch;
14. train: yi-6b at full width (depth cut to 4 layers,
   ``attn_impl="reference"`` as the JAX trainer uses, random weights from
   a seed) on 4 virtual data-parallel ranks, Markov batches of 8 x 512
   tokens, Torrent gradient reduction (``rs_ag``, K = 2). One step's
   grads reduced per leaf and in 25 MiB buckets must be equal bit for
   bit, and the two smallest leaves' reduced rows equal to the executor
   on the CPU and to ``chainwrite_ref.multi_all_reduce_ref``; then 8
   steps of bucketed exact-wire training and 8 of int8 + error-feedback
   training from the same init, each run a ``Trainer``'s state and step:
   finite losses, the first in [10.5, 12.5], the last below the first;
   every step's executor wire bytes equal to ``program_wire_bytes`` of
   the programs it ran; no retry of the caching allocator; no kernel
   launch (the path has none). Prints per-step wall, CUDA-event spans
   (fwd+bwd per rank, reduce, optimizer), tokens/s (of the median step
   and of the whole window), wire bytes, the modeled CC and peak memory
   (of the run and of each span). Last, ``python -m
   repro_torch.launch.train``'s ``main`` at smoke size on the card
   (int8 + EF, a failure injected at step 13): one restart from a
   checkpoint written from the card, and every step's loss within
   ``CLI_LOSS_TOL`` of a CPU Trainer's from the same initial params;
15. ep train: expert parallelism inside the Torrent train step:
   deepseek-moe-16b at full width (depth cut 28 -> 2 layers, 1 dense + 1
   MoE) on 4 virtual DP ranks of 2 x 512 tokens, through a ``Trainer``
   with ``moe_ep_dispatch``: one forward over the ranks whose MoE layer
   exchanges tokens by chain all-to-alls, one backward for every rank's
   grads, Torrent reduction (rs_ag, K = 2). 6 steps on the exact wires,
   6 on the int8 EP wire with int8 + EF reduction: finite losses, the
   first near ln(vocab); every step's EP all-to-all bytes (the
   executor's, counted over the joint fwd+bwd span) nonzero and equal to
   ``program_wire_bytes`` of those programs; no allocator retry; no
   kernel launch. Prints the train phase's record for each run;
16. cells: every assigned (arch x shape) cell built on the meta device
   by ``build_cell``, every arch's smoke cells and yi-6b's variants run
   from it, mamba2-2.7b and qwen2-vl-7b trained at full width through
   their train cells;
17. dist: the process form, one rank per process sharing the card over
   gloo (NCCL refuses two ranks on one device), whose frames go through
   pinned host buffers. First 4 ranks run the executor's matrix on CUDA
   tensors (broadcasts with K = 1, 2 and F = 1, 3; rs_ag and rotation
   all-reduce, reduce-scatter, all-gather, all-to-all; exact and int8
   wires): each rank's result equal to the stacked executor's row on the
   card bit for bit, each rank's bytes equal to their model (a ring
   rank's to ``program_wire_bytes``; a broadcast's ranks' sum to the
   members times the payload). Then yi-6b at full width, 2 of 32 layers,
   through the process-form ``Trainer`` on 2 ranks x 4 x 512 tokens
   (rs_ag, K = 1, 25 MiB buckets): the first step's reduced grads leaf by
   leaf bit for bit the stacked reduction of the two ranks' grads
   (all-gathered by the executor), then 2 exact, 2 int8 + EF and 2
   ``collectives="xla"`` steps (the backend's all-reduce) whose losses
   must equal a stacked ``Trainer``'s (``dp=2``, run in this process
   before the spawn) within ``DIST_LOSS_TOL``. Each rank holds AdamW's
   moments as its ZeRO-1 blocks over ``data = 2``: their bytes half the
   whole moments', the param all-gather's bytes a step equal to their
   count, and the exact and xla runs' params after the steps bit for bit
   the stacked run's (blake2b digests of every leaf). Per rank the step
   walls, the spans (``param_gather`` inside ``optimizer``), the
   transport, the wire bytes against the model, peak memory and
   allocator retries (must be 0); no kernel launch. Then expert
   parallelism across the processes:
   deepseek-moe-16b at full width, 2 of 28 layers, ``moe_ep_dispatch``
   (the MoE layer's dispatch and return as all-to-alls over the group,
   its backward the transposed exchange, the remat'd recompute's
   exchanges on the autograd engine's thread), one train step on 2
   ranks x 4 x 512 tokens against the stacked joint step that rank 0
   runs first from the same params and batch: loss, each leaf's update
   and the updates' cosine within ``DIST_EP_TOL``, the ranks' updates
   equal bit for bit, the EP bytes nonzero and the wire bytes equal to
   the model, no allocator retry, no kernel launch. A failing rank
   fails the phase;
18. tp: tensor parallelism in the process form. yi-6b at full width, 2
   of 32 layers, through the process-form ``Trainer`` at ``tp=2`` on a
   ``(data=1, model=2)`` mesh of two gloo ranks sharing the card (each
   rank holds its shards; Megatron's all-reduces over the model group
   go through pinned host buffers), 4 x 512 tokens a step: the first
   step's grads gathered leaf by leaf within ``TP_GRAD_TOL`` of the
   stacked ``Trainer``'s at TP = 1 (run first in this process from the
   same seed, then freed), then 2 exact and 2 int8 + EF steps whose
   losses equal across the ranks and within ``TP_LOSS_TOL`` of TP = 1;
   every leaf no spec splits equal bit for bit across the ranks after
   every step; the model group's payload bytes a step equal to
   ``modeled_tp_bytes``; ``tp_comm`` spans beside ``fwd_bwd``,
   ``reduce`` and ``optimizer``; per rank the init and step peak memory
   and no allocator retry; no kernel launch (``tp_train`` in the
   kernels line). A failing rank fails the phase.
19. tp families: the same on ``(data=1, model=2)`` for the MoE, MLA,
   Mamba-2 and hybrid families at full width: deepseek-v2-lite-16b (2
   of 27 layers: one dense, one MoE), mamba2-2.7b (2 of 64) and
   jamba-v0.1-52b (2 of 32: Mamba with a dense FFN, Mamba with a MoE).
   Per model (``TP_FAMILIES``): a TP = 1 reference from the same seed in
   this process, then freed — the stacked ``Trainer`` (its first step's
   grads and 2 steps' losses a run), or for jamba, whose TP = 1
   ``Trainer`` would pass the card, the first step's grads and loss of
   ``make_grad_fn`` alone; the MoE models' grads with the TP ranks
   routed as TP = 1 chose (``tests/_moe_routing.py``: bf16 rounding
   flips near-tie top-k choices). Then the two ranks: each rank's
   first-step grad shards within ``TP_GRAD_TOL`` of its block of the
   reference's, 2 exact (and, but for jamba, 2 int8 + EF) steps, with
   every check of phase 18. Then qwen2-vl-7b (2 of 28 layers: M-RoPE on
   each rank's 14 heads) and whisper-tiny (full size: encoder,
   cross-attention and GeLU FFNs split) through ``make_train_step`` on
   their own batches (``TP_FAMILIES_FIXED``: embeddings at the vlm
   phase's M-RoPE positions; tokens with encoder frames), held the same
   way against TP = 1's first-step f32 grads and 2 bf16 steps' losses.
   ``tp_families_train`` in the kernels line.
20. tp serve: tensor-parallel serving on ``(data=1, model=2)``, two
   gloo ranks sharing the card, full width, ``attn_impl="flash"``
   (``TP_SERVE``): yi-6b (8 of 32 layers), mamba2-2.7b (all 64),
   deepseek-v2-lite-16b (4 of 27), jamba-v0.1-52b (5 of 32), qwen2-vl-7b
   (4 of 28: the vlm phase's embeddings and positions, flash on each
   rank's 14 heads) and whisper-tiny (tokens with encoder frames, the
   plain attention); these two decode at one position for every row,
   with no admission. Per
   model a TP = 1 reference from the same seed in this process, with
   the plain attention (``attn_impl="reference"``), then
   freed: ``make_prefill_step`` on 4 x 512-token prompts, 32 greedy
   steps, a ``make_slot_prefill_step`` admission of a 256-token prompt
   written in with ``write_cache_slot`` before step 16 and per-slot
   positions from there, and one ``decode_step`` for the last logits
   (deepseek-v2-lite-16b: in both MLA decode forms). Then the two ranks,
   each holding its shards (``param_pspecs``, cut as drawn), drive the
   same traffic through the same step builders fed the reference's
   tokens and routed as it routed: their greedy tokens equal the
   reference's, or each token that differs is a near tie of its logits,
   prefill and last logits within ``TP_SERVE_LOGIT_TOL`` (jamba's decode
   ``TP_SERVE_DECODE_TOL``) of the reference's, both ranks' gathered
   logits bit-equal, the gathered cache (``sharding.gather_cache``)
   within ``TP_SERVE_CACHE_TOL`` of the reference's per leaf, the model
   group's payload of the prefill, a decode step and the admission equal
   to ``modeled_tp_serve_bytes``, no allocator retry, and per rank one
   flash launch (wgmma) per attention layer in each prefill. Prints per
   rank the state and peak memory, the prefill's and a decode step's
   event ms and the ``tp_comm`` share of the traffic's wall;
   ``tp_serve`` in the kernels line. The flash phase holds the kernel
   at the ranks' prefill and admission shapes here and on four cards'
   TP = 4. For mamba2-2.7b (f32 compute, bf16 conv window) a witness
   (``tp_serve_witness``) shows where its decode logits part from
   TP = 1's: the ranks' prefill cache within one bf16 step of TP = 1's,
   and TP = 1's decode started from that cache against its own. Last,
   deepseek-moe-16b (4 of 28 layers, ``TP_SERVE_DP``) on ``(data=2,
   model=1)``: each rank prefills its 2 of the 4 prompts and decodes 8
   steps, its flat MoE dispatch taking the global batch's capacity and
   positions (the ranks exchange their per-expert counts), routed as the
   whole-batch TP = 1 reference routed those rows; its logits, tokens
   and cache against the reference's rows, the exchange's bytes against
   ``modeled_tp_serve_bytes(dp=2)``. Its witness: the prefill again at
   a capacity factor of 0.5 (``TP_SERVE_DP_WITNESS_CF``), where the
   global rule must meet the whole batch's prefill, the per-rank rule
   (the data axis Manual) must miss it, and the two rules must keep a
   nonzero number of assignments differently.
21. long: ``build_cell``'s ``long_500k`` cell on ``(data=2, model=1)``,
   two gloo ranks sharing the card (``LONG``): h2o-danube-1.8b at full
   width and depth (its 4096-slot window, 2048 slots a rank) and
   mamba2-2.7b at full width, 4 of 64 layers. Each rank fills its cache
   block from a seeded whole cache and runs the cell's step (under
   ``hints.replicated_batch``: the sequence-parallel decode, the softmax
   combined over ``data``) at ``LONG_POSITIONS`` (0, a slot in rank 1's
   block, two wrapped past the window), held against ``decode_step`` on
   the whole cache with no mesh: the ranks' logits bit-equal, within
   ``TP_SERVE_LOGIT_TOL`` of the data = 1 decode in bf16 and within
   ``LONG_F32_TOL`` with both in f32 (mamba2-2.7b bit for bit), the
   tokens equal or near ties, the gathered cache within
   ``TP_SERVE_CACHE_TOL``, the combine's bytes equal to
   ``modeled_tp_serve_bytes(slot_split=2)``; a decode step's event ms.
   ``long_serve`` in the kernels line (no launch: decode attends by
   einsums). Expert parallelism under a live ``model`` axis runs on four
   cards, not here (``scripts/dist_cards.py --parts long``): its four
   ranks sharing this card took 75 s, past the script's time.

Then ``phase walls s: {...}`` (each phase's wall seconds, against the
script's time limit), one JSON line with every kernel's launches,
times, bound and error, and, as the last line, ``{"ok": true,
"device": {...}}``. In every case
of phases 2 and 3 the event times of the kernel and of its library call
(``ms``, ``library_ms``) are medians of 9 readings taken in turns
(``paired_ms``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.append(str(Path(__file__).resolve().parent / "tests"))  # _moe_routing


def card_rates() -> tuple[float, dict]:
    """The card's device-memory bytes/s and dense peak ops/s by dtype,
    from the port's machine description (``repro_torch.launch.roofline
    .H100_SXM``); f32 on the tf32x3 route runs three TF32 products per
    product, at a third of the TF32 rate."""
    from repro_torch.launch.roofline import H100_SXM as M

    return M.hbm_bw, {"bfloat16": M.peak_flops, "float16": M.peak_flops,
                      "float32": M.peak_flops_f32, "tf32x3": M.peak_flops_tf32 / 3}


# the train phase's smoke-size Trainer run on the card against the same
# run on the CPU: per-step loss difference (bf16 rounding order;
# measured 3.6e-4 on an H100)
CLI_LOSS_TOL = 5e-3
# the profiler's name of each flash route's kernels (tf32x3: the split
# pre-pass and the attention kernel)
FLASH_KERNEL_NAMES = {"wgmma": "flash_fwd_sm90_kernel", "tf32x3": "tf32x3"}

# bf16 kernel vs its f32-accumulating plain twin: both round one f32
# result to bf16, so they differ by at most one bf16 ulp (2^-8 relative)
# plus f32 reordering; f32: reordering of f32 sums only.
TOL = {"bfloat16": (2e-2, 1e-2), "float16": (2e-3, 2e-3), "float32": (1e-4, 1e-4)}
# flash vs reference prefill logits through 8 bf16 layers: the two
# attention paths round differently in every layer; relative to the
# logit scale.
LOGIT_REL_TOL = 2e-2


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fn_a, fn_b, rounds: int = 9) -> tuple[float, float]:
    """Event times of two calls compared within one run: ``time_ms`` of
    each in turns (a b, b a, ...), and the median of each over
    ``rounds`` turns. One 20-call reading of a host-bound call can vary
    by 2x from the next on this machine's shared host cores."""
    import statistics

    a, b = [], []
    for r in range(rounds):
        for fn, out in ((fn_a, a), (fn_b, b)) if r % 2 == 0 else ((fn_b, b), (fn_a, a)):
            out.append(time_ms(fn))
    return statistics.median(a), statistics.median(b)


def _cuda_keys(fn) -> set[str]:
    """Names of the CUDA kernels (and copies) one call of ``fn`` runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_ms(fn, kernel: str | None, iters: int = 20, flush=None) -> float:
    """Device time of ``kernel`` per call of ``fn``, from the profiler's
    CUDA trace; ``kernel=None`` sums every CUDA kernel of the call. With
    ``flush``, it runs before every call, and its own kernels are left
    out of the sum by name. A session whose trace holds no such kernel
    (the profiler can lose a session's kernel records) is taken again,
    up to three sessions, and then raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    skip = _cuda_keys(flush) if flush is not None else set()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            for e in prof.key_averages()
            if (kernel is None and e.device_type == DeviceType.CUDA and e.key not in skip)
            or (kernel is not None and kernel in e.key)
        )
        if total_us:
            return total_us / iters / 1e3
    raise RuntimeError(f"device_ms: three profiler sessions hold no kernel {kernel or ''}")


FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def l2_flush():
    """A call that leaves none of a case's bytes in L2: it reads a
    256 MiB buffer (a read, so the lines it leaves are clean and the
    next kernel pays no write-back for them)."""
    import torch

    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    return lambda: buf.sum()


def reset_launches() -> None:
    """Set every kernel wrapper's launch counters to 0."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.relayout import ops as R

    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route = dict.fromkeys(FA.ROUTES, 0)
    R.relayout.launches = 0
    R.relayout.launches_by_route = dict.fromkeys(R.ROUTES, 0)


def read_launches() -> dict:
    """The relayout's launches and the flash kernel's per route."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.relayout import ops as R

    return {"relayout": R.relayout.launches,
            **{f"flash_attention_{r}": n for r, n in FA.flash_attention.launches_by_route.items()}}


def div64_calls(sass: str) -> int:
    """Subroutine calls in ``cuobjdump -sass`` output. The relayout
    kernels call no function of their own, so a call there is one the
    compiler inserted: the 64-bit integer division/remainder routine,
    which cuobjdump shows as an unnamed ``CALL.REL.NOINC <address>``."""
    return sum(1 for line in sass.splitlines() if re.search(r"\bCALL\.", line))


def relayout_phase() -> dict:
    import torch
    from repro_torch.kernels.relayout import ops as R
    from repro_torch.launch.paged_kv import paged_ref

    def nbytes(t):
        return t.numel() * t.element_size()

    hbm_bytes_per_s, _ = card_rates()
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = l2_flush()
    cases = [
        # (name, shape, src, dst, dtype, element offset, route): the serve
        # phase's paged-KV relayout first (plen 384, F = 8 layers * 2 *
        # 4 kv heads * 128)
        ("paged_kv", (384, 8192), (1, 8192), (8, 8192), torch.bfloat16, 0, "copy"),
        ("MNM16N8->MNM8N8", (2048, 192), (16, 8), (8, 8), torch.float32, 0, "staged"),
        ("MNM16N8->MNM64N16", (2048, 192), (16, 8), (64, 16), torch.float32, 0, "staged"),
        ("MNM8N8->MNM16N16", (2048, 192), (8, 8), (16, 16), torch.float32, 0, "staged"),
        ("MNM16N8->MNM8N8 int8", (2048, 192), (16, 8), (8, 8), torch.int8, 0, "staged"),
        # beyond L2: 64 MiB a side
        ("MNM16N8->MNM8N8 int8 large", (8192, 8192), (16, 8), (8, 8), torch.int8, 0, "staged"),
        ("MNM16N8->MNM64N16 bf16 large", (8192, 4096), (16, 8), (64, 16), torch.bfloat16, 0,
         "staged"),
        # the paged-KV shape one element past an aligned address
        ("paged_kv misaligned", (384, 8192), (1, 8192), (8, 8192), torch.bfloat16, 1, "direct"),
    ]
    main = None
    for name, shape, src, dst, dtype, offset, route in cases:
        M, N = shape
        dense = (torch.randn(shape, device="cuda", generator=gen) * 8).to(dtype)
        blocked = R.dense_to_blocked(dense, src)
        if offset:
            base = torch.empty(blocked.numel() + offset, dtype=dtype, device="cuda")
            base[offset:].copy_(blocked.reshape(-1))
            x = base[offset:].view(blocked.shape)
        else:
            x = blocked
        before = dict(R.relayout.launches_by_route)
        got = R.relayout(x, shape, src, dst)
        want = R.relayout_ref(x, shape, src, dst)
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in R.relayout.launches_by_route.items()}
        if moved != {r: int(r == route) for r in moved}:
            raise AssertionError(f"relayout {name}: route {route} but launches moved {moved}")
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"relayout {name}: kernel differs from relayout_ref")
        if name == "paged_kv":
            paged = got[:, 0]
            if not torch.equal(paged.view(torch.uint8), paged_ref(dense, dst[0]).view(torch.uint8)):
                raise AssertionError("relayout paged_kv: kernel differs from paged_ref")

        def library(x=x, shape=shape, dst=dst):
            dm = x.permute(0, 2, 1, 3).reshape(shape)
            return dm.reshape(M // dst[0], dst[0], N // dst[1], dst[1]).permute(
                0, 2, 1, 3).clone(memory_format=torch.contiguous_format)

        if not torch.equal(library().view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"relayout {name}: library expression differs")
        kernel = lambda: R.relayout(x, shape, src, dst)  # noqa: E731
        kernel_ms, library_ms = paired_ms(kernel, library)
        rec = {
            "name": name, "route": route, "shape": list(shape), "src": list(src),
            "dst": list(dst), "dtype": str(dtype).split(".")[-1], "offset": offset,
            "plan": R._plan(shape, src, dst, x.element_size(), x.data_ptr() % 16,
                            got.data_ptr() % 16, R._SMS[0]).info,
            "ms": kernel_ms,
            "device_ms_hot": device_ms(kernel, "relayout_"),
            "device_ms_cold": device_ms(kernel, "relayout_", flush=flush),
            "plain_ms": time_ms(lambda: R.relayout_ref(x, shape, src, dst)),
            "library_ms": library_ms,
            "library_device_ms_hot": device_ms(library, None),
            "library_device_ms_cold": device_ms(library, None, flush=flush),
            "bound_ms": 2 * nbytes(x) / hbm_bytes_per_s * 1e3,
            "max_abs_err": float((got.double() - want.double()).abs().max()),
        }
        rec["device_ms"] = rec["device_ms_hot"]
        rec["library_device_ms"] = rec["library_device_ms_hot"]
        for key in ("device_ms_cold", "library_device_ms_cold"):
            share = rec["bound_ms"] / rec[key]
            rec[key.replace("ms_cold", "cold_share_of_bound")] = share
            if share > 1.05:
                raise AssertionError(
                    f"relayout {name}: {key} {rec[key]} ms is {share:.0%} of the HBM "
                    f"bound {rec['bound_ms']} ms: the L2 flush did not take")
        print("relayout", json.dumps(rec), flush=True)
        main = main or rec
    return main


def flash_phase() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FA

    hbm_bytes_per_s, peak_ops_per_s = card_rates()
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # (name, B, H, Hkv, S, D, dtype, causal, window, route): the serve
        # phase's prefill shape (yi-6b heads, S=512) first
        ("yi6b_prefill", 1, 32, 4, 512, 128, bf16, True, None, "wgmma"),
        ("yi6b_prefill_4k", 1, 32, 4, 4096, 128, bf16, True, None, "wgmma"),
        ("yi6b_prefill_f32", 1, 32, 4, 512, 128, f32, True, None, "tf32x3"),
        ("yi6b_prefill_4k_f32", 1, 32, 4, 4096, 128, f32, True, None, "tf32x3"),
        # the moe serve phase's prefill shape (deepseek-moe-16b: MHA, 16 heads)
        ("dsmoe_prefill", 1, 16, 16, 512, 128, bf16, True, None, "wgmma"),
        # the hybrid serve phase's (jamba-v0.1-52b's GQA layer: 32 heads,
        # 8 KV heads, no positions)
        ("jamba_prefill", 1, 32, 8, 512, 128, bf16, True, None, "wgmma"),
        # the vlm decode phase's (qwen2-vl-7b: 28 heads on 4 KV heads, a
        # GQA group of 7; make_prefill_step runs the batch's 4 prompts at once)
        ("qwen2vl_prefill", 4, 28, 4, 512, 128, bf16, True, None, "wgmma"),
        # one rank's shape in the tp serve phase's prefill (4 x 512 tokens,
        # TP = 2: half the query heads and of the KV heads), and on the four
        # cards' TP = 4 (yi-6b: 32 heads on 4 KV heads; jamba: 32 on 8)
        ("yi6b_tp2_rank", 4, 16, 2, 512, 128, bf16, True, None, "wgmma"),
        ("jamba_tp2_rank", 4, 16, 4, 512, 128, bf16, True, None, "wgmma"),
        ("yi6b_tp4_rank", 4, 8, 1, 512, 128, bf16, True, None, "wgmma"),
        ("jamba_tp4_rank", 4, 8, 2, 512, 128, bf16, True, None, "wgmma"),
        # qwen2-vl-7b's TP ranks: 14 heads on 2 KV heads at TP = 2 (the tp
        # serve phase's prefill), 7 on 1 at TP = 4 (the four cards')
        ("qwen2vl_tp2_rank", 4, 14, 2, 512, 128, bf16, True, None, "wgmma"),
        ("qwen2vl_tp4_rank", 4, 7, 1, 512, 128, bf16, True, None, "wgmma"),
        # the same ranks' slot admission (make_slot_prefill_step of one
        # 256-token prompt), at TP = 2 on one card and TP = 4 on four
        ("yi6b_tp2_slot", 1, 16, 2, 256, 128, bf16, True, None, "wgmma"),
        ("jamba_tp2_slot", 1, 16, 4, 256, 128, bf16, True, None, "wgmma"),
        ("yi6b_tp4_slot", 1, 8, 1, 256, 128, bf16, True, None, "wgmma"),
        ("jamba_tp4_slot", 1, 8, 2, 256, 128, bf16, True, None, "wgmma"),
        ("f32_window", 2, 4, 2, 384, 64, f32, True, 48, "tf32x3"),
        ("f32_window_noncausal", 1, 4, 4, 200, 64, f32, False, 100, "tf32x3"),
        # h2o-danube-1.8b's head dim, padded 80 -> 128
        ("d80_gqa", 1, 8, 2, 256, 80, bf16, True, None, "wgmma"),
        ("d256", 1, 2, 1, 128, 256, f32, True, None, "tf32x3"),
        ("f32_d40_ragged", 2, 4, 1, 333, 40, f32, True, None, "tf32x3"),
        ("ragged_449_window", 1, 8, 1, 449, 128, bf16, True, 48, "wgmma"),
        ("d192_noncausal", 1, 4, 2, 300, 192, bf16, False, None, "wgmma"),
        ("f16_d16", 2, 4, 1, 96, 16, f16, True, None, "wgmma"),
        ("bf16_d40", 1, 4, 2, 160, 40, bf16, True, None, "wgmma"),
        # 4096-token prefills at the entry's other head dims: 16-bit
        # D % 16 == 8 (padded to 64), f32 D > 128 (a pair of blocks)
        ("bf16_d40_4k", 1, 32, 4, 4096, 40, bf16, True, None, "wgmma"),
        ("f32_d192_4k", 1, 16, 16, 4096, 192, f32, True, None, "tf32x3"),
        ("f32_d256_4k", 1, 8, 2, 4096, 256, f32, True, None, "tf32x3"),
    ]
    recs = {}
    for name, B, H, Hkv, S, D, dtype, causal, window, route in cases:
        q = torch.randn((B, H, S, D), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(dtype)
        v = torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(dtype)
        kw = dict(causal=causal, window=window)
        if FA._route(dtype, D) != route:
            raise AssertionError(f"flash {name}: routed to {FA._route(dtype, D)}, not {route}")
        before = dict(FA.flash_attention.launches_by_route)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in FA.flash_attention.launches_by_route.items()}
        if moved != {r: int(r == route) for r in moved}:
            raise AssertionError(f"flash {name}: route {route} but launches moved {moved}")
        if got.dtype != q.dtype or got.shape != q.shape:
            raise AssertionError(f"flash {name}: output {got.dtype} {tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name}: non-finite output")
        dt = str(dtype).split(".")[-1]
        atol, rtol = TOL[dt]
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bad.any():
            raise AssertionError(
                f"flash {name}: {int(bad.sum())} elements beyond atol={atol} "
                f"rtol={rtol}; max abs err {float(err.max())}"
            )
        rows = torch.arange(S, device="cuda")[:, None]
        cols = torch.arange(S, device="cuda")[None, :]
        mask = torch.ones((S, S), dtype=torch.bool, device="cuda")
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window

        def library():
            if window is None:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        kernel_name = FLASH_KERNEL_NAMES[route]
        kernel = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
        kernel_ms, library_ms = paired_ms(kernel, library)
        pairs = int(mask.sum())  # (row, col) pairs this input needs
        flops = 4 * D * B * H * pairs  # QK^T and PV, 2 flops per MAC
        io_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops = flops / peak_ops_per_s["tf32x3" if route == "tf32x3" else dt]
        t_bytes = io_bytes / hbm_bytes_per_s
        rec = {
            "name": name, "route": route, "shape": [B, H, Hkv, S, D], "dtype": dt,
            "causal": causal, "window": window, "atol": atol, "rtol": rtol,
            "ms": kernel_ms,
            "device_ms": device_ms(kernel, kernel_name),
            "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw)),
            "library_ms": library_ms,
            "library_device_ms": device_ms(library, None),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": float(err.max()),
        }
        if dt == "float32":
            rec["bound_ms_cuda_cores"] = max(flops / peak_ops_per_s["float32"], t_bytes) * 1e3
            rec["bound_ms_tf32x3"] = max(flops / peak_ops_per_s["tf32x3"], t_bytes) * 1e3
        if route == "tf32x3":
            rec["split_device_ms"] = device_ms(kernel, "tf32x3_split_kernel")
        rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
        print("flash", json.dumps(rec), flush=True)
        recs[name] = rec
    return recs


def f32_attention_path() -> dict:
    """``flash_attention`` on f32 inputs, as a caller of the kernel entry
    point with f32 activations makes it: at yi-6b's heads (S=512, causal)
    and at deepseek-v2-lite's query-key head dim 192 (16 heads, S=256),
    both on the 3xTF32 tensor-core route (the second as a pair of blocks
    that split the head dim). Returns the launch counts of the run,
    counted from 0."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA

    gen = torch.Generator(device="cuda").manual_seed(3)
    calls = []
    for H, Hkv, S, D in ((32, 4, 512, 128), (16, 16, 256, 192)):
        q = torch.randn((1, H, S, D), device="cuda", generator=gen)
        k = torch.randn((1, Hkv, S, D), device="cuda", generator=gen)
        v = torch.randn((1, Hkv, S, D), device="cuda", generator=gen)
        calls.append((q, k, v, FA.flash_attention_plain(q, k, v)))
    reset_launches()
    outs = [FA.flash_attention(q, k, v) for q, k, v, _ in calls]
    torch.cuda.synchronize()
    by_route = dict(FA.flash_attention.launches_by_route)
    atol, rtol = TOL["float32"]
    bad = 0
    for got, (q, _, _, want) in zip(outs, calls):
        err = (got - want).abs()
        bad += int((err > atol + rtol * want.abs()).sum())
        print(f"f32 path: D {q.shape[-1]}, max abs err vs plain {float(err.max()):.3g}",
              flush=True)
    print(f"f32 path: launches {by_route}", flush=True)
    if by_route != {"wgmma": 0, "tf32x3": 2} or bad:
        raise AssertionError(f"f32 path: launches {by_route}, {bad} elements beyond tolerance")
    return by_route


def host_syncs(fn) -> int:
    """How many times ``fn`` makes the host wait for the card: the
    warnings of CUDA's sync debug mode while it runs (the mode's own
    notice that it is a prototype, which may miss some syncs, is not
    counted)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def moe_layer_phase() -> dict:
    """One deepseek-moe-16b MoE layer at full width on 8 virtual ranks of
    512 tokens: flat, rowwise and expert-parallel dispatch against
    ``moe_ref`` and each other, the EP wire bytes against the byte
    model, and the CUDA-event time of each path."""
    import torch
    from repro_torch import configs as C
    from repro_torch.core import chainwrite as cw
    from repro_torch.core import program as prg
    from repro_torch.models import moe as M
    from repro_torch.parallel.collectives import sub_ring_orders

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, T = 8, 512
    base = C.get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(base, capacity_factor=8.0)  # no drops: paths comparable
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.moe_init(gen, cfg, "cuda")
    x = torch.randn((n, 1, T, d), device="cuda", generator=gen).to(torch.bfloat16)
    xb = x.reshape(n, T, d)  # the same tokens as (B, S, d) for the single-device paths

    def close(name, got, want):
        err = (got.float() - want.float()).abs()
        bad = int((err > 2e-2 + 2e-2 * want.float().abs()).sum())
        if bad:
            raise AssertionError(f"moe layer {name}: {bad} elements beyond 2e-2; "
                                 f"max abs err {float(err.max())}")
        return float(err.max())

    errs, wire, outs = {}, {}, {}
    with torch.no_grad():
        ref = M.moe_ref(params, xb, cfg)
        scale = float(ref.float().abs().max())
        flat, flat_aux = M.moe_apply(params, xb, cfg)
        errs["flat_vs_ref"] = close("flat", flat, ref)
        row, row_aux = M.moe_apply_rowwise(params, xb, cfg)
        errs["rowwise_vs_ref"] = close("rowwise", row, ref)
        for K in (1, 2):
            for w in (None, "int8"):
                cw.wire_counter.reset()
                o, a = M.moe_apply_ep(params, x, cfg, num_chains=K, wire_dtype=w)
                torch.cuda.synchronize()
                wire[K, w] = (cw.wire_counter.bytes, cw.wire_counter.modeled_bytes())
                outs[K, w] = (o.reshape(xb.shape), a)
        ep, ep_aux = outs[1, None]
        errs["ep_vs_flat"] = close("ep", ep, flat)
        if not (torch.equal(ep, outs[2, None][0]) and torch.equal(ep_aux, outs[2, None][1])):
            raise AssertionError("moe layer: EP with K = 1 and K = 2 differ")
        for K in (1, 2):
            e8 = float((outs[K, "int8"][0].float() - ref.float()).abs().max()) / scale
            errs[f"ep_int8_k{K}_vs_ref_over_scale"] = e8
            if not e8 < 0.1:
                raise AssertionError(f"moe layer: int8 EP (K = {K}) is {e8:.3g} of the scale off")
        # the single-device paths (serving's) never wait for the card;
        # bincount (it reads its input's range back) shows the check sees
        syncs = {name: host_syncs(fn) for name, fn in (
            ("flat", lambda: M.moe_apply(params, xb, cfg)),
            ("rowwise", lambda: M.moe_apply_rowwise(params, xb, cfg)),
            ("ep_exact", lambda: M.moe_apply_ep(params, x, cfg)),
            ("bincount", lambda: torch.bincount(torch.arange(64, device="cuda"))))}
        if syncs["flat"] or syncs["rowwise"] or not syncs["bincount"]:
            raise AssertionError(f"moe layer: host syncs {syncs}")
        aux = {"flat": float(flat_aux), "rowwise": float(row_aux), "ep": float(ep_aux),
               "ep_int8": float(outs[1, "int8"][1])}
        if max(abs(v - aux["flat"]) for v in aux.values()) > 1e-5 * aux["flat"]:
            raise AssertionError(f"moe layer: aux losses {aux}")

        C_pair = M._bucket_capacity(T * cfg.moe_top_k, n, cfg.capacity_factor)
        books = {}
        for K in (1, 2):
            orders = tuple(sub_ring_orders(n, K))
            exact = prg.plan_all_to_all(n, orders)
            q8 = prg.plan_all_to_all(n, orders, wire_dtype="int8")
            tok = n * C_pair * d  # elements each device sends
            ids = prg.program_wire_bytes(exact, n * C_pair * 4)
            books[K] = {
                "exact": 2 * prg.program_wire_bytes(exact, tok * 2) + ids,
                "int8": 2 * prg.program_wire_bytes(q8, tok * 4) + ids,
                "token_f32": 2 * prg.program_wire_bytes(exact, tok * 4),
                "scale_bytes": 2 * 4 * sum(st.num_permutes() for st in q8.steps),
                "ids": ids,
            }
            for w in (None, "int8"):
                got, model = wire[K, w]
                if not got == model == books[K]["int8" if w else "exact"]:
                    raise AssertionError(f"moe layer K = {K} {w}: wire bytes {got}, model "
                                         f"{model}, programs {books[K]}")
            b = books[K]
            if b["int8"] - b["ids"] != b["token_f32"] // 4 + b["scale_bytes"]:
                raise AssertionError(f"moe layer: int8 token bytes {b}")

        def timed(c):
            fns = {
                "flat": lambda: M.moe_apply(params, xb, c),
                "rowwise": lambda: M.moe_apply_rowwise(params, xb, c),
                "ep_exact": lambda: M.moe_apply_ep(params, x, c),
                "ep_int8": lambda: M.moe_apply_ep(params, x, c, wire_dtype="int8"),
            }
            return {k: time_ms(f, iters=5, warmup=1) for k, f in fns.items()}

        times = {"capacity_8": timed(cfg), f"capacity_{base.capacity_factor}": timed(base)}
    rec = {"tokens_per_rank": T, "ranks": n, "C_pair": C_pair, "errors": errs, "aux": aux,
           "host_syncs": syncs,
           "int8_k1_equals_k2": bool(torch.equal(outs[1, "int8"][0], outs[2, "int8"][0])),
           "wire_bytes": {f"k{K}_{w or 'exact'}": wire[K, w][0] for K, w in wire},
           "byte_books": {f"k{K}": b for K, b in books.items()},
           "times_ms": times, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("moe layer", json.dumps(rec), flush=True)
    del params, x, xb, ref, flat, row, outs
    torch.cuda.empty_cache()
    return rec


def same_routing_prefill(params, cfg, toks, max_seq):
    """Prefill logits through the flash kernel and through the reference
    attention. The MoE layers of the second are routed as those of the
    first chose (``tests/_moe_routing.py``: the reference's own
    probabilities, gathered at the flash run's experts): the top-k
    choice is discontinuous, and the two attentions' roundings can flip
    a near tie, which moves a token's output by O(1); the count of such
    flips is returned."""
    import torch
    from _moe_routing import recorded_routing, routing_as
    from repro_torch.models import transformer as T

    def prefill(impl):
        c = dataclasses.replace(cfg, attn_impl=impl)
        return T.prefill(params, c, {"tokens": toks}, max_seq)[0]

    with torch.no_grad():
        with recorded_routing() as seen:
            lf = prefill("flash")
        with routing_as(seen) as flips:
            lr = prefill("reference")
    torch.cuda.synchronize()
    return lf, lr, sum(int(f.sum()) for f in flips)


def serve_prompts(V: int):
    """The serve phases' traffic, from seed 0: a 384-token shared prefix,
    then 6 prompts that extend it by 16..128 tokens and 2 of 256..512
    fresh tokens that miss it."""
    import numpy as np

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, V, size=384).astype(np.int32)
    prompts = []
    for _ in range(6):  # prefix hits: prefix + 16..128 suffix tokens
        suffix = rng.integers(0, V, size=int(rng.integers(16, 129))).astype(np.int32)
        prompts.append(np.concatenate([prefix, suffix]))
    for _ in range(2):  # misses: 256..512 fresh tokens
        p = rng.integers(0, V, size=int(rng.integers(256, 513))).astype(np.int32)
        p[0] = (prefix[0] + 1) % V
        prompts.append(p)
    return prefix, prompts


SERVE_CONFIG = dict(smoke=False, batch=4, replicas=4, page_size=8, prompt_len=512,
                    max_seq=546, seed=0)


@dataclasses.dataclass(frozen=True)
class ServePath:
    """One serve phase: the arch, its depth cut, the kernel launches its
    run makes, whether its cache admits KV-prefix multicast (a mamba
    layer's cache has no per-position axis, and ``register_prefix`` must
    refuse it) and how many replicas its ``Server`` runs."""

    arch: str
    layers: int
    launches: dict
    kv_multicast: bool = True
    replicas: int = 4


# Flash: one launch per attention layer of each prefill (the registered
# prefix and the 2 misses; with no KV multicast, the prefix prefill that
# ``register_prefix`` makes before it refuses, as the JAX package's does,
# and the 8 misses), all on the wgmma route; MLA attends by einsums, as
# the JAX package's does, so its path launches none, and neither does
# attention-free mamba2. Relayout: one launch (copy route) per replica
# that pages the KV prefix.
SERVE_PATHS = {
    "serve": ServePath("yi-6b", 8, {"relayout": 4, "flash_attention": 3 * 8}),
    "moe serve": ServePath("deepseek-moe-16b", 4, {"relayout": 4, "flash_attention": 3 * 4}),
    "mla serve": ServePath("deepseek-v2-lite-16b", 4, {"relayout": 4, "flash_attention": 0}),
    # full depth: 2.83 B params; the phase holds ~5x them (params, the
    # refresh payload and 3 delivered copies), 57 GB
    "ssm serve": ServePath("mamba2-2.7b", 64, {"relayout": 0, "flash_attention": 0},
                           kv_multicast=False),
    # 5 of 32 layers, the shallowest cut that holds the GQA layer
    # (attn_offset 4): 7.15 B params, 28.6 GB f32; one replica, since ~5x
    # the params fit no card and ssm serve covers an SSM's weight multicast
    "hybrid serve": ServePath("jamba-v0.1-52b", 5, {"relayout": 0, "flash_attention": 1 + 8},
                              kv_multicast=False, replicas=1),
}
# mamba layers: a layer's chunked mixer against its recurrence on the
# same inputs, within LOGIT_REL_TOL of its output scale (CPU, width 512,
# 64 layers: at most 0.94%); the last logits of a prefill against a
# shorter prefill and decode steps drift through the 64 layers by the
# two forms' bf16 roundings (prefill rounds the conv output before silu,
# decode does not: 9-14% of the logit scale on the CPU at widths
# 256-1024, 2.3e-5 with every rounding removed), so that one is held to
# a bound that a wrong state handoff (O(scale)) still breaks
SSM_DRIFT_TOL = 0.25


def serve_phase(label: str) -> dict:
    """``Server.run()`` for the arch of ``SERVE_PATHS[label]`` at full
    width, depth cut as that entry says, with ``attn_impl="flash"`` and
    random weights: weight multicast, a 384-token shared prefix
    registered and multicast (refused where the cache admits no KV
    multicast), then the 8 prompts of 32 new tokens each (6 prefix hits
    and 2 misses, or 8 misses). The kernel launches must be the entry's."""
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.relayout import ops as R
    from repro_torch.launch.paged_kv import kv_feature_width
    from repro_torch.launch.serve import ServeConfig, Server
    from repro_torch.tree import leaves

    path = SERVE_PATHS[label]
    arch, layers, want_launches = path.arch, path.layers, path.launches
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(C.get_config(arch), num_layers=layers, attn_impl="flash")
    sc = ServeConfig(arch=arch, **{**SERVE_CONFIG, "replicas": path.replicas})
    t0 = time.perf_counter()
    server = Server(sc, device="cuda", model_cfg=cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(server.params))
    print(f"{label}: model init {time.perf_counter() - t0:.2f}s, {n_params} params "
          f"({4 * n_params / 1e9:.2f} GB f32)", flush=True)

    V = cfg.vocab_size
    prefix, prompts = serve_prompts(V)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats()["num_alloc_retries"]
    spans = {}
    t0 = time.perf_counter()
    wrec = server.broadcast_weights(chunk_bytes=64 << 20)
    torch.cuda.synchronize()
    spans["broadcast_weights_64MiB_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if path.kv_multicast:
        entry = server.register_prefix(prefix)
    else:
        try:
            server.register_prefix(prefix)
        except ValueError as e:
            print(f"{label}: register_prefix refused: {e}", flush=True)
        else:
            raise AssertionError(f"{label}: register_prefix accepted a cache with no "
                                 "per-position axis")
        if server.prefix_cache.entries or server.kv_multicast_log:
            raise AssertionError(f"{label}: a refused prefix left an entry or a KV record")
    torch.cuda.synchronize()
    spans["register_prefix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.broadcast_weights()  # the refresh run() starts with: 1 MiB chunks
    torch.cuda.synchronize()
    spans["broadcast_weights_1MiB_s"] = time.perf_counter() - t0
    reqs = [server.submit(p, 32) for p in prompts]
    out = server.run(reqs)
    torch.cuda.synchronize()
    spans["run_s"] = out["wall_s"]
    launches = {"relayout": R.relayout.launches, "flash_attention": FA.flash_attention.launches}
    by_route = dict(FA.flash_attention.launches_by_route)
    relayout_routes = dict(R.relayout.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries0

    print(f"{label}: weight multicast", json.dumps(wrec), flush=True)
    if path.kv_multicast:
        print(f"{label}: kv multicast", json.dumps(entry.broadcast), flush=True)
    print(f"{label}: run", json.dumps(out), flush=True)
    print(f"{label}: wall_s {out['wall_s']:.3f} tokens/s {out['tokens_per_s']:.2f} "
          f"peak memory {peak_gb:.1f} GB alloc retries {retries} launches {launches} "
          f"flash by route {by_route} relayout by route {relayout_routes}", flush=True)
    print(f"{label}: spans", json.dumps(spans), flush=True)

    if out["served"] != len(reqs) or not all(len(r.out) == 32 for r in reqs):
        raise AssertionError(f"{label}: served {out['served']} of {len(reqs)} requests")
    want_hits = [True] * 6 + [False] * 2 if path.kv_multicast else [False] * 8
    if [r.prefix_hit for r in reqs] != want_hits:
        raise AssertionError(f"{label}: prefix hits {[r.prefix_hit for r in reqs]}")
    if any(not 0 <= t < V for r in reqs for t in r.out):
        raise AssertionError(f"{label}: a generated token is outside the vocabulary")
    delivered = sum(x.numel() * x.element_size() for x in server.last_delivery.values())
    copies = path.replicas - 1
    if wrec["delivered_bytes"] != copies * wrec["bytes"] or delivered != wrec["delivered_bytes"]:
        raise AssertionError(f"{label}: weight multicast delivered {wrec['delivered_bytes']} B")
    if not copies and not (wrec["noop"] and wrec["chunks"] == 0):
        raise AssertionError(f"{label}: one replica's weight refresh is not a no-op: {wrec}")
    if path.kv_multicast and entry.broadcast["delivered_bytes"] != 3 * entry.broadcast["bytes"]:
        raise AssertionError(f"{label}: KV multicast did not reach every replica")
    if retries:
        raise AssertionError(f"{label}: the caching allocator retried {retries} times")
    if launches != want_launches:
        raise AssertionError(f"{label}: kernel launches {launches}, the path makes "
                             f"{want_launches}")
    if by_route != {**dict.fromkeys(FA.ROUTES, 0), "wgmma": launches["flash_attention"]}:
        raise AssertionError(f"{label}: flash launches {launches['flash_attention']} "
                             f"by route {by_route}")
    if relayout_routes != {**dict.fromkeys(R.ROUTES, 0), "copy": launches["relayout"]}:
        raise AssertionError(f"{label}: relayout launches {launches['relayout']} "
                             f"by route {relayout_routes}")
    kv = None
    if path.kv_multicast:
        F = kv_feature_width(server.cache, sc.max_seq)
        kv = {"F": F, "F_per_layer": F // layers, "prefix_tokens": len(prefix),
              "payload_bytes": entry.broadcast["bytes"],
              "delivered_bytes": entry.broadcast["delivered_bytes"]}
        if entry.broadcast["bytes"] != len(prefix) * F * 2:
            raise AssertionError(f"{label}: KV payload {entry.broadcast['bytes']} B != "
                                 f"{len(prefix)} positions x F {F} x 2 B")
        print(f"{label}: kv multicast per position", json.dumps(kv), flush=True)

    specs = [cfg.layer_spec(i) for i in range(layers)]
    if any(s.mixer != "mamba" for s in specs):
        # flash vs reference attention on one prompt, same weights
        toks = torch.as_tensor(prompts[-1], device="cuda")[None]
        lf, lr, flips = same_routing_prefill(server.params, cfg, toks, sc.max_seq)
        if lf.shape != (1, V) or not torch.isfinite(lf).all():
            raise AssertionError(f"{label}: flash prefill logits {tuple(lf.shape)} not finite")
        d = float((lf - lr).abs().max())
        scale = float(lr.abs().max())
        print(f"{label}: prefill logits flash vs reference: max |d| {d:.5f}, "
              f"max |ref| {scale:.3f}, argmax {int(lf.argmax())} vs {int(lr.argmax())}, "
              f"routing flips the reference would make {flips}", flush=True)
        if d > LOGIT_REL_TOL * scale:
            raise AssertionError(f"{label}: flash prefill logits differ by {d} "
                                 f"(> {LOGIT_REL_TOL} x {scale})")
    if any(s.mixer == "mamba" for s in specs):
        ssm_checks(label, server, cfg, sc, prompts[-1])
    absorb = mla_absorb_decode(server.params, cfg, sc) if cfg.attention == "mla" else None
    profile_run(server, [prompts[0], prompts[-1]])
    return {"relayout": launches["relayout"], "flash_attention_wgmma": by_route["wgmma"],
            "relayout_by_route": relayout_routes, "kv": kv, "mla_absorb": absorb}


def ssm_checks(label: str, server, cfg, sc, prompt, S: int = 200, k: int = 8) -> None:
    """The SSD's two forms at full width on the card, and their times.
    Each mamba layer's chunked mixer (``mamba2_apply``) on the hidden
    states of a prefill of ``prompt[:S]`` against its recurrence
    (``mamba2_prefill`` of the first S - k, then k ``mamba2_decode``
    steps) on the same inputs, over the last k tokens: the chunked form
    pads S to whole chunks, so this crosses a padded chunk boundary.
    For an attention-free model, also the last logits of a whole-model
    ``prefill(S)`` against ``prefill(S - k)`` and k ``decode_step`` calls
    (``SSM_DRIFT_TOL``). Every logit must be finite. Prints the
    CUDA-event time of one decode step of the serve batch and of one
    512-token prefill."""
    import torch
    from repro_torch.models import mamba2 as mb
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.tree import leaves

    params = server.params
    toks = torch.as_tensor(prompt[:S], device="cuda")[None]
    positions = torch.arange(S, dtype=torch.int32, device="cuda")[None]
    layer_errs = []
    with torch.no_grad():
        x = embed(params["embed"], toks)
        for (pattern, reps), stacked in zip(cfg.layer_groups(), params["groups"]):
            for r in range(reps):
                for spec, p in zip(pattern, stacked):
                    p = T._index(p, r)
                    if spec.mixer == "mamba":
                        h = rmsnorm(p["norm1"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
                        full = mb.mamba2_apply(p["mixer"], h, cfg)[:, S - k:].float()
                        _, cache = mb.mamba2_prefill(p["mixer"], h[:, : S - k], cfg)
                        rec = torch.cat([mb.mamba2_decode(p["mixer"], h[:, t : t + 1], cache,
                                                          cfg)[0] for t in range(S - k, S)], 1)
                        if not torch.isfinite(full).all():
                            raise AssertionError(f"{label}: a mamba layer's output is not finite")
                        layer_errs.append(float((full - rec.float()).abs().max()
                                                / full.abs().max()))
                    x, _ = T.layer_apply(p, spec, cfg, x, positions)
    rec = {"S": S, "k": k, "mamba_layers": len(layer_errs),
           "layer_rel_err_max": max(layer_errs),
           "layer_rel_err_median": sorted(layer_errs)[len(layer_errs) // 2]}
    if cfg.family == "ssm":
        with torch.no_grad():
            lf, _ = T.prefill(params, cfg, {"tokens": toks}, sc.max_seq)
            lp, cache = T.prefill(params, cfg, {"tokens": toks[:, : S - k]}, sc.max_seq)
            for t in range(S - k, S):
                lp, cache = T.decode_step(params, cfg, toks[:, t],
                                          torch.tensor(t, dtype=torch.int32, device="cuda"),
                                          cache)
        if not (torch.isfinite(lf).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"{label}: prefill or decode logits not finite")
        rec["logits_rel_drift"] = float((lf - lp).abs().max() / lf.abs().max())
        rec["argmax"] = [int(lf.argmax()), int(lp.argmax())]

    B = sc.batch
    gen = torch.Generator(device="cuda").manual_seed(7)
    cache = T.init_cache(cfg, B, sc.max_seq, device="cuda")
    cur = torch.randint(0, cfg.vocab_size, (B,), device="cuda", generator=gen)
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    p512 = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda", generator=gen)
    with torch.no_grad():
        rec["decode_step_ms"] = time_ms(lambda: T.decode_step(params, cfg, cur, pos, cache),
                                        iters=10)
        rec["prefill_512_ms"] = time_ms(lambda: T.prefill(params, cfg, {"tokens": p512},
                                                          sc.max_seq), iters=3, warmup=1)
    rec["cache_bytes_per_slot"] = sum(t.nbytes // B for t in leaves(server.cache))
    print(f"{label}: ssm", json.dumps(rec), flush=True)
    if rec["layer_rel_err_max"] > LOGIT_REL_TOL:
        raise AssertionError(f"{label}: a mamba layer's chunked and recurrent forms differ by "
                             f"{rec['layer_rel_err_max']} of its scale (> {LOGIT_REL_TOL})")
    if rec.get("logits_rel_drift", 0.0) > SSM_DRIFT_TOL:
        raise AssertionError(f"{label}: prefill and decode logits drift by "
                             f"{rec['logits_rel_drift']} of their scale (> {SSM_DRIFT_TOL})")


def mla_absorb_decode(params, cfg, sc) -> dict:
    """One decode step of the serve batch at full width against a full
    compressed cache (T = max_seq, every slot at position max_seq - 1,
    cache values from a seed), with K/V recovered from the cache per
    step and with the up-projections absorbed (``cfg.mla_absorb``): the
    CUDA-event time of each and the difference of their logits. The
    absorbed run's MoE layers are routed as the recovering run's chose
    (``tests/_moe_routing.py``), so the two differ only by their
    attention's rounding."""
    import torch
    from _moe_routing import recorded_routing, routing_as
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    B, S = sc.batch, sc.max_seq
    gen = torch.Generator(device="cuda").manual_seed(5)
    cache = T.init_cache(cfg, B, S, device="cuda")
    for leaf in leaves(cache["layers"]):
        leaf.copy_(torch.randn(leaf.shape, device="cuda", generator=gen))
    toks = torch.randint(0, cfg.vocab_size, (B,), device="cuda", generator=gen)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
    fns = {name: (lambda c=dataclasses.replace(cfg, mla_absorb=absorb):
                  T.decode_step(params, c, toks, pos, cache)[0])
           for name, absorb in (("recovered", False), ("absorbed", True))}
    with torch.no_grad():
        with recorded_routing() as seen:
            recovered = fns["recovered"]()
        with routing_as(seen) as flips:
            absorbed = fns["absorbed"]()
        torch.cuda.synchronize()
        rec, absorbed_ms = paired_ms(fns["recovered"], fns["absorbed"], rounds=5)
    d = float((absorbed - recovered).abs().max())
    scale = float(recovered.abs().max())
    out = {"batch": B, "T": S, "recovered_ms": rec, "absorbed_ms": absorbed_ms,
           "recovered_over_absorbed": rec / absorbed_ms, "max_abs_diff": d, "logit_scale": scale,
           "routing_flips": sum(int(f.sum()) for f in flips)}
    print("mla decode, absorbed vs recovered", json.dumps(out), flush=True)
    if not (torch.isfinite(absorbed).all() and d <= LOGIT_REL_TOL * scale):
        raise AssertionError(f"mla decode: absorbed logits differ by {d} (> {LOGIT_REL_TOL} "
                             f"x {scale})")
    return out


def profile_run(server, prompts) -> None:
    """Where the time goes: one more ``run()`` (weight refresh included)
    with two requests, a prefix hit and a miss, under the profiler's CUDA
    trace."""
    reqs = [server.submit(p, 8) for p in prompts]
    device_breakdown("run()", lambda: server.run(reqs))


def device_breakdown(label: str, fn) -> None:
    """Run ``fn`` once under the profiler's CUDA trace; print the
    device's busy share of the wall time and the kernels that took most
    of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: {label} wall {wall_us / 1e6:.3f}s, device busy {busy_us / 1e6:.3f}s "
          f"({busy_us / wall_us:.1%}), idle share {1 - busy_us / wall_us:.1%}", flush=True)
    for name, us in top:
        print(f"profile:   {us / 1e3:10.3f} ms  {us / busy_us:6.1%}  {name[:100]}", flush=True)
    # The profiler's events are cyclic garbage. Left to the collector,
    # they are freed by a generation-2 pass at some later allocation,
    # which may fall inside a timed step: the host enqueues a train step
    # nearly as slowly as the card runs it, so a host pause there is a
    # gap in the device's spans. Collect them now, outside any timing.
    del prof
    t0 = time.perf_counter()
    freed = gc.collect()
    print(f"profile: {label}: gc freed {freed} objects in {time.perf_counter() - t0:.3f}s",
          flush=True)


def mem_spans():
    """A :class:`~repro_torch.runtime.spans.Spans` that also keeps each
    phase's peak allocated memory (the allocator's peak is reset as a
    span starts and read as it ends; ``peak`` holds the highest reading
    per phase name) and the executor's wire bytes when each phase last
    ended (``wire_at_end``)."""
    import torch
    from repro_torch.core import chainwrite as cw
    from repro_torch.runtime.spans import Spans

    class MemSpans(Spans):
        def __init__(self):
            super().__init__()
            self.peak, self.wire_at_end = {}, {}

        @contextlib.contextmanager
        def span(self, name, device):
            torch.cuda.reset_peak_memory_stats()
            with super().span(name, device):
                yield
            self.peak[name] = max(self.peak.get(name, 0), torch.cuda.max_memory_allocated())
            self.wire_at_end[name] = cw.wire_counter.bytes

    return MemSpans()


def trainer_step(tr, i: int) -> dict:
    """One step of a ``Trainer``'s state and step function on batch
    ``i``; returns the step's metrics."""
    st = tr.state
    if "ef" in st:
        p_, o_, e_, m = tr.step_fn(st["params"], st["opt"], st["ef"], tr._device_batch(i))
        tr.state = {"params": p_, "opt": o_, "ef": e_}
    else:
        p_, o_, m = tr.step_fn(st["params"], st["opt"], tr._device_batch(i))
        tr.state = {"params": p_, "opt": o_}
    return m


def drive_trainer(label: str, tr, spans, steps: int, tokens_per_step: int, topo) -> dict:
    """Drive a ``Trainer``'s state and step function ``steps`` steps (and
    one more under the profiler) and return the run's record (``tr`` may
    be any object with a ``state`` dict, a ``step_fn`` and a
    ``_device_batch(i)``): losses,
    per-step wall, CUDA-event spans, tokens/s, the executor's wire bytes
    per step against the byte model's (they must be equal) and the int8
    frames' scale bytes among them, the bytes of
    the expert-parallel all-to-alls (the programs the ``fwd_bwd`` span
    ran: the executor's count when that span ends, and the byte model of
    the ``all_to_all`` programs), the modeled CC, peak memory, allocator
    retries (must be 0) and each step's Python GC seconds."""
    import numpy as np
    import torch
    from repro_torch.core import chainwrite as cw
    from repro_torch.core import program as prg
    from repro_torch.core import simulator as sim

    gc_clock = {}  # seconds of Python GC passes since cleared

    def gc_timer(phase, info):
        if phase == "start":
            gc_clock["t0"] = time.perf_counter()
        else:
            gc_clock["s"] = gc_clock.get("s", 0.0) + time.perf_counter() - gc_clock.pop("t0")

    def modeled(collective=None):
        return sum(n * prg.pipelined_wire_bytes(p, size, frames)
                   for (p, size, frames), n in cw.wire_counter.runs.items()
                   if collective in (None, p.collective))

    gc.callbacks.append(gc_timer)
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats()["num_alloc_retries"]
    state_gb = torch.cuda.memory_allocated() / 1e9  # params, AdamW moments, EF residuals
    losses, walls, span_ms, wire, model, ep, ep_model, cc, gc_s, scales = ([] for _ in range(10))
    peak = torch.cuda.max_memory_allocated()  # the state
    for i in range(steps):
        cw.wire_counter.reset()
        torch.cuda.synchronize()
        gc_clock.clear()
        t0 = time.perf_counter()
        loss = float(trainer_step(tr, i)["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        gc_s.append(gc_clock.get("s", 0.0))
        peak = max(peak, torch.cuda.max_memory_allocated())  # since the last span began
        losses.append(loss)
        span_ms.append({k: [round(v, 3) for v in vs] for k, vs in spans.read().items()})
        wire.append(cw.wire_counter.bytes)
        model.append(modeled())
        ep.append(spans.wire_at_end["fwd_bwd"])
        ep_model.append(modeled("all_to_all"))
        cc.append(sum(n * sim.program_latency(topo, 0, p, size)
                      for (p, size, _), n in cw.wire_counter.runs.items()))
        # the f32 scale (4 B) each int8 frame carries
        scales.append(sum(n * 4 * sum(st.num_permutes() for st in p.steps
                                      if p.step_wire_dtype(st) == "int8")
                          for (p, _, _), n in cw.wire_counter.runs.items()))
        if wire[-1] != model[-1] or ep[-1] != ep_model[-1]:
            raise AssertionError(f"{label} step {i}: executor wire bytes {wire[-1]} (EP "
                                 f"{ep[-1]}) != program_wire_bytes {model[-1]} (EP "
                                 f"{ep_model[-1]})")
    gc.callbacks.remove(gc_timer)
    peak_gb = max(peak, *spans.peak.values()) / 1e9
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries0
    cw.wire_counter.reset()
    device_breakdown(f"{label} step", lambda: trainer_step(tr, steps))  # not one of the timed steps
    spans.read()
    rec = {
        "losses": losses, "step_wall_s": walls,
        "median_step_s": float(np.median(walls)),
        "tokens_per_s": tokens_per_step / float(np.median(walls)),
        "window_tokens_per_s": steps * tokens_per_step / sum(walls),
        "spans_ms": span_ms[-1], "max_fwd_bwd_ms": max(max(m["fwd_bwd"]) for m in span_ms),
        "step_gc_s": gc_s,
        "wire_bytes_per_step": wire[-1], "wire_scale_bytes_per_step": scales[-1],
        "modeled_wire_bytes_per_step": model[-1], "modeled_cc_per_step": cc[-1],
        "ep_wire_bytes_per_step": ep[-1], "ep_modeled_wire_bytes_per_step": ep_model[-1],
        "peak_memory_gb": peak_gb, "alloc_retries": retries,
        "state_memory_gb": state_gb,
        "phase_peak_memory_gb": {k: v / 1e9 for k, v in spans.peak.items()},
    }
    print(f"{label}:", json.dumps(rec), flush=True)
    if retries:
        raise AssertionError(f"{label}: the caching allocator freed its cache and "
                             f"retried {retries} times (peak {peak_gb:.1f} GB)")
    return rec


def train_phase() -> dict:
    """The training path: yi-6b at full width, depth cut to 4 layers,
    4 virtual DP ranks on the card, Torrent gradient reduction (rs_ag,
    K = 2). One step's grads reduced per leaf and bucketed (equal bit
    for bit, and the two smallest leaves equal to the CPU executor and
    the numpy oracle), then 8 steps of bucketed exact-wire training and
    8 of int8 + error-feedback training from the same init. Every
    step's executor wire bytes must equal the byte model's."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.core import chainwrite as cw
    from repro_torch.core import chainwrite_ref as ref
    from repro_torch.core.topology import MeshTopology
    from repro_torch.data.pipeline import MarkovSource, make_device_placer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import H100_SXM, modeled_train_overlap
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import parse_args as train_args
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collectives as col
    from repro_torch.tree import leaves, map_tree

    torch.cuda.empty_cache()
    # yi-6b at full width (d_model 4096, 32 heads, 4 kv heads, head_dim
    # 128, d_ff 11008, vocab 64000, untied head); depth cut 32 -> 4 so
    # f32 params (4.9 GB), AdamW moments (9.7 GB), the 4 ranks' stacked
    # grads (19.5 GB) and, for int8 + EF, the 4 ranks' residuals
    # (19.5 GB) fit one 80 GB card beside the reduction's transients.
    layers = 4
    cfg = dataclasses.replace(C.get_config("yi-6b"), num_layers=layers, attn_impl="reference")
    dp, B, S, steps = 4, 8, 512, 8
    mesh = make_host_mesh(data=dp)
    K, algo, bucket = 2, "rs_ag", 25 << 20
    source = MarkovSource(vocab=cfg.vocab_size, seq_len=S, global_batch=B, seed=1)
    place = make_device_placer("cuda")
    topo = MeshTopology(dp, 1)

    def init():
        return T.model_init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # 1. one step's grads, reduced per leaf and bucketed
    params = init()
    n_params = sum(p.numel() for p in leaves(params))

    grad_fn = make_grad_fn(cfg, loss_chunks=8)

    batch = place(source.batch(0))
    stacked, metrics0 = col.stack_rank_grads(grad_fn, params, batch, dp)
    kw = dict(num_chains=K, algo=algo)
    cw.wire_counter.reset()
    per_leaf = col.make_stacked_reduce(mesh, **kw)(stacked)
    leaf_bytes = (cw.wire_counter.bytes, cw.wire_counter.modeled_bytes())
    cw.wire_counter.reset()
    bucketed = col.make_stacked_reduce(mesh, bucket_bytes=bucket, **kw)(stacked)
    bucket_bytes_ = (cw.wire_counter.bytes, cw.wire_counter.modeled_bytes())
    torch.cuda.synchronize()
    unequal = [i for i, (a, b) in enumerate(zip(per_leaf, bucketed)) if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"train: bucketed != per-leaf reduce at leaves {unequal}")
    if leaf_bytes[0] != leaf_bytes[1] or bucket_bytes_[0] != bucket_bytes_[1]:
        raise AssertionError(f"train: wire bytes {leaf_bytes} / {bucket_bytes_} != model")
    k, rings = col.resolve_ring_chains(dp, 1, num_chains=K, algo=algo)
    smallest = sorted(range(len(stacked)), key=lambda i: stacked[i][0].numel())[:2]
    for i in smallest:
        flat = stacked[i].reshape(dp, -1)
        card = cw.multi_chain_all_reduce(flat, rings, algo=algo)
        cpu = cw.multi_chain_all_reduce(flat.cpu(), rings, algo=algo)
        oracle = ref.multi_all_reduce_ref(flat.cpu().numpy(), rings, algo)
        div = torch.tensor(float(dp), device="cuda")
        if not (torch.equal(card.cpu(), cpu) and np.array_equal(cpu.numpy(), oracle)
                and torch.equal(per_leaf[i].reshape(-1), card[0] / div)):
            raise AssertionError(f"train: leaf {i} ({flat.shape[1]} elements) differs "
                                 "between card, CPU executor and numpy oracle")
    print(f"train: grads of one step, {n_params} params x {dp} ranks: per-leaf == bucketed "
          f"({len(per_leaf)} leaves); leaves {smallest} == CPU executor == numpy oracle; "
          f"wire bytes per-leaf {leaf_bytes[0]} bucketed {bucket_bytes_[0]} (model equal); "
          f"loss {float(metrics0['loss']):.4f}", flush=True)
    del stacked, per_leaf, bucketed, params, batch
    torch.cuda.empty_cache()

    # 2. and 3. training from one init through the Trainer: exact wire,
    # then int8 + EF. Its steps are driven one by one (as
    # benchmarks/bench_train.py drives the JAX Trainer), so each is timed
    # and its wire bytes read; Trainer.run() would also write the step-0
    # checkpoint, 15-34 GB of state at this width (step 4 runs it).
    runs = {}
    for name, compress in (("exact", False), ("int8_ef", True)):
        spans = mem_spans()
        tr = Trainer(TrainConfig(
            arch="yi-6b", smoke=False, layers=layers, steps=steps, global_batch=B,
            seq_len=S, peak_lr=5e-4, warmup_steps=2, collectives="torrent", num_chains=K,
            compress_grads=compress, bucket_bytes=bucket, loss_chunks=8, dp=dp, seed=0),
            device="cuda", spans=spans)  # the step's ar_algo defaults to rs_ag
        rec = drive_trainer(f"train {name}", tr, spans, steps, B * S, topo)
        first, last = rec["losses"][0], rec["losses"][-1]
        if not all(np.isfinite(rec["losses"])) or not 10.5 <= first <= 12.5 or not last < first:
            raise AssertionError(f"train {name}: losses {rec['losses']}")
        runs[name] = rec
        del tr
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the cost model beside the measurement: modeled_train_overlap on
    # the card's machine for this step's leaves, per-rank tokens and
    # knobs; its wire bytes must equal the executor's count exactly
    meta = leaves(T.model_init(torch.Generator(), cfg, device="meta"))
    model = {name: modeled_train_overlap(meta, dp, B * S // dp, bucket_bytes=bucket,
                                         num_chains=K, algo=algo, machine=H100_SXM,
                                         wire_dtype="int8" if name == "int8_ef" else None)
             for name in runs}
    cc_ms = 64 / H100_SXM.link_bw * 1e3  # one NoC cycle moves 64 B of a link
    for name, m in model.items():
        spans = runs[name]["spans_ms"]
        print(f"train {name} model vs measured: " + json.dumps({
            "buckets": len(m["buckets"]), "num_chains": sorted({b["num_chains"]
                                                                for b in m["buckets"]}),
            "modeled_backward_ms_per_rank": m["buckets"][-1]["ready_cc"] * cc_ms,
            "measured_fwd_bwd_ms_per_rank": spans["fwd_bwd"],
            "modeled_comm_ms": sum(b["comm_cc"] for b in m["buckets"]) * cc_ms,
            "measured_reduce_ms": spans["reduce"],
            "modeled_serial_ms": m["serial_cc"] * cc_ms,
            "modeled_overlap_ms": m["overlap_cc"] * cc_ms, "efficiency": m["efficiency"],
            "modeled_wire_bytes": m["total_wire_bytes"],
            "executor_wire_bytes": runs[name]["wire_bytes_per_step"]}), flush=True)
        if m["total_wire_bytes"] != runs[name]["wire_bytes_per_step"]:
            raise AssertionError(f"train {name}: modeled wire bytes {m['total_wire_bytes']} != "
                                 f"the executor's {runs[name]['wire_bytes_per_step']}")

    # 4. the Trainer's own loop, as `python -m repro_torch.launch.train`
    # runs it, at smoke size: int8 + EF with a failure injected at step
    # 13, so the state (EF residuals included) is checkpointed from the
    # card and restored onto it. A CPU Trainer from the card's initial
    # params is the reference for the losses.
    ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    argv = ["--smoke", "--steps", "20", "--batch", "8", "--seq", "32", "--dp", "4",
            "--collectives", "torrent", "--num-chains", "2", "--compress-grads",
            "--bucket-mb", "0.0625", "--lr", "2e-3", "--ckpt-every", "10",
            "--fail-at", "13", "--ckpt-dir"]
    tc, _ = train_args(argv + [str(ckpt_root / "cpu")])
    card_init = T.model_init(torch.Generator(device="cuda").manual_seed(tc.seed),
                             C.get_smoke_config(tc.arch), "cuda")
    logging.disable(logging.INFO)
    try:
        card = train_main(argv + [str(ckpt_root / "cuda")])
        cpu = Trainer(tc, device="cpu", params=map_tree(torch.Tensor.cpu, card_init)).run()
    finally:
        logging.disable(logging.NOTSET)
        shutil.rmtree(ckpt_root, ignore_errors=True)
    diff = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    print(f"train cli: {' '.join(argv)} DIR: final step {card['final_step']}, restarts "
          f"{card['restarts']}, losses {card['first_loss']:.4f} -> {card['last_loss']:.4f}, "
          f"max |card - cpu| {diff:.3g} over {len(card['losses'])} steps", flush=True)
    if (card["final_step"], card["restarts"]) != (20, 1) or not (
            np.isfinite(card["losses"]).all() and len(card["losses"]) == len(cpu["losses"])
            and diff < CLI_LOSS_TOL and card["last_loss"] < card["first_loss"]):
        raise AssertionError(f"train cli: card {card['losses']} cpu {cpu['losses']}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"train: the training path launched kernels {launches}")
    print(f"train: losses exact {runs['exact']['losses']}", flush=True)
    print(f"train: losses int8+ef {runs['int8_ef']['losses']}", flush=True)
    print(f"train: wire bytes per step exact {runs['exact']['wire_bytes_per_step']} "
          f"int8 {runs['int8_ef']['wire_bytes_per_step']} (ratio "
          f"{runs['exact']['wire_bytes_per_step'] / runs['int8_ef']['wire_bytes_per_step']:.3f}); "
          f"kernel launches {launches}", flush=True)
    return {"train_launches": launches, "runs": runs}


def ep_train_phase() -> dict:
    """Expert parallelism inside the Torrent train step: deepseek-moe-16b
    at full width, depth cut 28 -> 2 layers (1 dense + 1 MoE), 4 virtual
    DP ranks of 2 x 512 tokens each, Torrent gradient reduction (rs_ag,
    K = 2, 25 MiB buckets), through a ``Trainer`` built with
    ``moe_ep_dispatch``: one forward over the 4 ranks whose MoE layer
    exchanges tokens with chain all-to-alls, one backward for every
    rank's grads. 6 steps on the exact wires, then 6 with the int8 EP
    token wire and int8 + error-feedback gradient reduction, from one
    init. Finite losses; every step's EP all-to-all bytes (the executor's
    count over the joint fwd+bwd span) equal to ``program_wire_bytes`` of
    the all-to-all programs that ran, and nonzero; no allocator retry; no
    kernel launch (the path has none)."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.core.topology import MeshTopology
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    layers, dp, B, S, steps, K = 2, 4, 8, 512, 6, 2
    reset_launches()
    runs = {}
    for name, int8 in (("exact", False), ("int8_ef", True)):
        spans = mem_spans()
        cfg = dataclasses.replace(C.get_config("deepseek-moe-16b"), moe_ep_dispatch=True,
                                  moe_ep_int8_wire=int8)
        tr = Trainer(TrainConfig(
            arch="deepseek-moe-16b", smoke=False, layers=layers, steps=steps, global_batch=B,
            seq_len=S, peak_lr=5e-4, warmup_steps=2, collectives="torrent", num_chains=K,
            compress_grads=int8, bucket_bytes=25 << 20, loss_chunks=8, dp=dp, seed=0),
            device="cuda", spans=spans, model_cfg=cfg)
        if name == "exact":
            n_params = sum(p.numel() for p in leaves(tr.state["params"]))
            print(f"ep train: deepseek-moe-16b, {layers} layers, {n_params} params "
                  f"({4 * n_params / 1e9:.2f} GB f32) x {dp} ranks", flush=True)
        rec = drive_trainer(f"ep train {name}", tr, spans, steps, B * S, MeshTopology(dp, 1))
        # random init: the first loss is near ln(vocab)
        if (not np.isfinite(rec["losses"]).all()
                or abs(rec["losses"][0] - np.log(tr.cfg.vocab_size)) > 1.0):
            raise AssertionError(f"ep train {name}: losses {rec['losses']}")
        if rec["ep_wire_bytes_per_step"] <= 0:
            raise AssertionError(f"ep train {name}: no expert-parallel exchange ran")
        if len(rec["spans_ms"]["fwd_bwd"]) != 1:
            raise AssertionError(f"ep train {name}: fwd_bwd spans {rec['spans_ms']} (one joint "
                                 "forward and backward a step)")
        runs[name] = rec
        del tr
        torch.cuda.empty_cache()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"ep train: the training path launched kernels {launches}")
    ex, q8 = runs["exact"], runs["int8_ef"]
    print(f"ep train: EP wire bytes per step exact {ex['ep_wire_bytes_per_step']} int8 "
          f"{q8['ep_wire_bytes_per_step']}; tokens/s exact {ex['tokens_per_s']:.1f} int8+ef "
          f"{q8['tokens_per_s']:.1f}; kernel launches {launches}", flush=True)
    return {"train_launches": launches, "runs": runs}

# qwen2-vl's image-then-text layout: a 1 x 16 x 16 patch grid, then 256
# text tokens, 32 greedy decode steps
VLM_GRID, VLM_TEXT, VLM_STEPS = (16, 16), 256, 32
# the first decode step's logits against a reference prefill of the S + 1
# rows (tests/test_models_smoke.py:217's bound), relative to the logit
# scale; and the least change, relative to that scale, that the image
# layout's positions must make against text positions
DECODE_REL_TOL = 8e-2
POSITION_EFFECT_MIN = 0.1
# the audio train phase's 4-rank Torrent reduction against one rank on the
# whole batch: the loss, relative; each grad leaf's error norm over its norm
# (the two differ by bf16 roundings of per-rank matmuls)
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 2e-2


def generate(prefill_step, serve_step, params, batch, steps: int, pos_at):
    """Prefill ``batch``, then ``steps`` greedy decode steps (step i at
    position ``pos_at(i)``), with every kernel's launch count set to 0
    just before and read just after. Returns the prefill's logits, the
    generated tokens ((B,) each, ``steps`` + 1), the cache, the wall
    seconds, the launches, the allocator's retries and the peak memory
    (GB)."""
    import torch

    with torch.no_grad():
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        retries0 = torch.cuda.memory_stats()["num_alloc_retries"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch)
        cur = logits.argmax(-1).to(torch.int32)
        generated = [cur]
        for i in range(steps):
            cur, cache = serve_step(params, cur, pos_at(i), cache)
            generated.append(cur)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries0
    return (logits, generated, cache, wall, launches, retries,
            torch.cuda.max_memory_allocated() / 1e9)


def vlm_positions(B: int, grid: tuple[int, int], text: int, device):
    """(3, B, gh*gw + text) int32 M-RoPE positions of an image followed
    by text, as Qwen2-VL lays them out: patch i of the (1, gh, gw) grid
    at (0, i // gw, i % gw), then text whose three streams run on from
    the grid's maximum + 1."""
    import torch

    gh, gw = grid
    i = torch.arange(gh * gw, device=device)
    img = torch.stack([torch.zeros_like(i), i // gw, i % gw])
    t = max(gh, gw) + torch.arange(text, device=device)
    pos = torch.cat([img, t.expand(3, text)], 1).to(torch.int32)
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous()


def vlm_decode_phase() -> dict:
    """qwen2-vl-7b at full width and full depth (28 layers, M-RoPE,
    ``attn_impl="flash"``, random f32 weights from a seed) through the
    step builders JAX's cells use: ``make_prefill_step(cfg, 546)`` on 4
    prompts of 512 random bf16 embeddings at the image-then-text
    positions, then ``VLM_STEPS`` greedy ``make_serve_step`` steps at a
    scalar position (JAX's M-RoPE decode takes no per-slot one). The
    flash kernel launches once per layer of the prefill (28, ``wgmma``),
    no relayout, no allocator retry; the flash prefill's logits against
    the reference attention's (``LOGIT_REL_TOL``), the first decode
    step's against a reference prefill of the S + 1 rows
    (``DECODE_REL_TOL``), the image layout's against text positions
    (apart by at least ``POSITION_EFFECT_MIN`` of the scale); every
    logit finite. Prints event times of one prefill of the batch and of
    one decode step, tokens/s, peak memory and a profiled run."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(C.get_config("qwen2-vl-7b"), attn_impl="flash")
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    B, max_seq = SERVE_CONFIG["batch"], SERVE_CONFIG["max_seq"]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.model_init(gen, cfg, "cuda")
    positions = vlm_positions(B, VLM_GRID, VLM_TEXT, "cuda")
    S = positions.shape[2]
    # patch and text embeddings at the token table's scale
    embeds = (torch.randn((B, S, cfg.d_model), device="cuda", generator=gen) * 0.02).to(
        torch.bfloat16)
    batch = {"embeds": embeds, "positions": positions}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    print(f"vlm decode: qwen2-vl-7b, {cfg.num_layers} layers, model init "
          f"{time.perf_counter() - t0:.2f}s, {n_params} params ({4 * n_params / 1e9:.2f} GB f32)",
          flush=True)
    prefill_step, serve_step = make_prefill_step(cfg, max_seq), make_serve_step(cfg)
    # decode step i runs at S + i: the reference's decode_step takes one
    # pos for the cache row it writes and the rotary position, so it cannot
    # rotate at Qwen2-VL's positions.max() + 1 + i (the rope delta) while
    # writing row S + i

    def pos_at(t):
        return torch.tensor(t, dtype=torch.int32, device="cuda")

    logits, generated, cache, wall, launches, retries, peak_gb = generate(
        prefill_step, serve_step, params, batch, VLM_STEPS, lambda i: pos_at(S + i))
    cur = generated[-1]
    with torch.no_grad():
        ref, _ = T.prefill(params, ref_cfg, batch, max_seq)
        _, fresh = prefill_step(params, batch)
        first, _ = T.decode_step(params, cfg, generated[0], pos_at(S), fresh)
        del fresh
        longer = {"embeds": torch.cat([embeds, embed(params["embed"], generated[0][:, None])], 1),
                  "positions": torch.cat([positions, torch.full((3, B, 1), S, dtype=torch.int32,
                                                                device="cuda")], 2)}
        full, _ = T.prefill(params, ref_cfg, longer, max_seq)
        text = torch.arange(S, dtype=torch.int32, device="cuda").expand(3, B, S)
        as_text, _ = prefill_step(params, {"embeds": embeds, "positions": text})
        torch.cuda.synchronize()
        prefill_ms = time_ms(lambda: prefill_step(params, batch), iters=3, warmup=1)
        last = pos_at(S + VLM_STEPS)
        decode_ms = time_ms(lambda: serve_step(params, cur, last, cache), iters=10)
        syncs = host_syncs(lambda: serve_step(params, cur, last, cache))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rec = {"batch": B, "prompt": S, "grid": list(VLM_GRID), "new_tokens": VLM_STEPS,
           "params": n_params, "wall_s": wall,
           "tokens_per_s": B * (VLM_STEPS + 1) / wall,
           "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "decode_tokens_per_s": B / decode_ms * 1e3,
           "flash_vs_reference_rel": rel(logits, ref),
           "decode_vs_prefill_rel": rel(first, full),
           "image_vs_text_positions_rel": rel(as_text, logits),
           "argmax": [int(logits[0].argmax()), int(ref[0].argmax())],
           "cache_bytes": sum(t.nbytes for t in leaves(cache)), "decode_host_syncs": syncs,
           "peak_memory_gb": peak_gb, "alloc_retries": retries, "launches": launches}
    print("vlm decode", json.dumps(rec), flush=True)
    if syncs:
        raise AssertionError(f"vlm decode: a decode step makes the host wait for the card "
                             f"{syncs} times")
    if not all(torch.isfinite(t).all() for t in (logits, ref, first, full, as_text)):
        raise AssertionError("vlm decode: non-finite logits")
    if launches != {"relayout": 0, "flash_attention_wgmma": cfg.num_layers,
                    "flash_attention_tf32x3": 0}:
        raise AssertionError(f"vlm decode: launches {launches}, the path makes "
                             f"{cfg.num_layers} wgmma flash launches (one prefill)")
    if retries:
        raise AssertionError(f"vlm decode: the caching allocator retried {retries} times")
    if rec["flash_vs_reference_rel"] > LOGIT_REL_TOL:
        raise AssertionError(f"vlm decode: flash prefill logits {rec['flash_vs_reference_rel']} "
                             f"of the scale from the reference's (> {LOGIT_REL_TOL})")
    if rec["decode_vs_prefill_rel"] > DECODE_REL_TOL:
        raise AssertionError(f"vlm decode: the first decode step's logits "
                             f"{rec['decode_vs_prefill_rel']} of the scale from a prefill of "
                             f"S + 1 rows (> {DECODE_REL_TOL})")
    if rec["image_vs_text_positions_rel"] < POSITION_EFFECT_MIN:
        raise AssertionError(f"vlm decode: the image layout moves the logits only "
                             f"{rec['image_vs_text_positions_rel']} of the scale")

    def profiled():
        with torch.no_grad():
            _, c = prefill_step(params, batch)
            t = generated[0]
            for i in range(8):
                t, c = serve_step(params, t, pos_at(S + i), c)

    device_breakdown("vlm decode: prefill + 8 decode steps", profiled)
    del params, cache
    return launches


AUDIO_PROMPT, AUDIO_STEPS, AUDIO_MAX_SEQ = 64, 32, 128


def audio_frames(gen, B: int, cfg):
    """Random bf16 frame embeddings (the stub conv frontend's output)."""
    import torch

    return torch.randn((B, cfg.encoder_seq_len, cfg.d_model), device="cuda",
                       generator=gen).to(torch.bfloat16)


def audio_decode_phase() -> dict:
    """whisper-tiny at full size (4 encoder + 4 decoder layers, 1500
    frames, vocab 51,865; reference attention, random weights from a
    seed): first, the flash encoder at 1500 frames must be refused with
    JAX's ``ValueError``. Then ``make_prefill_step`` on 4 prompts of 64
    tokens with their frames, and ``AUDIO_STEPS`` greedy
    ``make_serve_step`` steps at a per-slot ``(B,)`` position. Each
    step's logits (the same decode replayed) against ``forward_hidden``
    over the prompt plus the tokens so far (``DECODE_REL_TOL``); the
    scalar-position step equal to the per-slot one; no kernel launch, no
    allocator retry. Prints event times of ``encode``, the prefill and a
    decode step, tokens/s and peak memory."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import unembed
    from repro_torch.tree import leaves, map_tree

    gc.collect()
    torch.cuda.empty_cache()
    cfg = C.get_config("whisper-tiny")
    B = SERVE_CONFIG["batch"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.model_init(gen, cfg, "cuda")
    n_params = sum(p.numel() for p in leaves(params))
    frames = audio_frames(gen, B, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (B, AUDIO_PROMPT), device="cuda", generator=gen,
                            dtype=torch.int32)
    batch = {"tokens": prompts, "enc_frames": frames}
    with torch.no_grad():
        try:
            T.encode(params, dataclasses.replace(cfg, attn_impl="flash"), frames)
        except ValueError as e:
            print(f"audio decode: flash encoder at {cfg.encoder_seq_len} frames refused: {e}",
                  flush=True)
        else:
            raise AssertionError("audio decode: the flash encoder took 1500 frames")
    prefill_step = make_prefill_step(cfg, AUDIO_MAX_SEQ)
    serve_step = make_serve_step(cfg)

    def pos_at(t):
        return torch.full((B,), t, dtype=torch.int32, device="cuda")

    _, generated, cache, wall, launches, retries, peak_gb = generate(
        prefill_step, serve_step, params, batch, AUDIO_STEPS, lambda i: pos_at(AUDIO_PROMPT + i))
    cur = generated[-1]
    with torch.no_grad():
        # replay the decode for its logits, each against the forward
        _, cache = prefill_step(params, batch)
        toks, errs, same_tokens, scalar_equal = prompts, [], 0, True
        for i in range(AUDIO_STEPS):
            t = generated[i]
            toks = torch.cat([toks, t[:, None]], 1)
            p = AUDIO_PROMPT + i
            scalar, _ = T.decode_step(params, cfg, t, torch.tensor(p, dtype=torch.int32,
                                                                   device="cuda"),
                                      map_tree(torch.clone, cache))
            step, cache = T.decode_step(params, cfg, t, pos_at(p), cache)
            scalar_equal &= bool(torch.equal(scalar, step))
            same_tokens += int(torch.equal(step.argmax(-1).to(torch.int32), generated[i + 1]))
            hidden, _ = T.forward_hidden(params, cfg, {"tokens": toks, "enc_frames": frames},
                                         remat="none")
            want = unembed(params["lm_head"], hidden[:, -1])
            if not (torch.isfinite(step).all() and torch.isfinite(want).all()):
                raise AssertionError(f"audio decode step {i}: non-finite logits")
            errs.append(float((step - want).abs().max() / want.abs().max()))
        encode_ms = time_ms(lambda: T.encode(params, cfg, frames), iters=10)
        prefill_ms = time_ms(lambda: prefill_step(params, batch), iters=10)
        first = pos_at(AUDIO_PROMPT)
        decode_ms = time_ms(lambda: serve_step(params, cur, first, cache), iters=20)
        syncs = host_syncs(lambda: serve_step(params, cur, first, cache))
    rec = {"batch": B, "prompt": AUDIO_PROMPT, "frames": cfg.encoder_seq_len,
           "new_tokens": AUDIO_STEPS, "params": n_params, "wall_s": wall,
           "tokens_per_s": B * (AUDIO_STEPS + 1) / wall, "encode_ms": encode_ms,
           "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "decode_tokens_per_s": B / decode_ms * 1e3,
           "decode_vs_forward_rel_max": max(errs), "decode_vs_forward_rel_median":
           sorted(errs)[len(errs) // 2], "scalar_equals_per_slot": scalar_equal,
           "replayed_steps_same_tokens": same_tokens,
           "cache_bytes": sum(t.nbytes for t in leaves(cache)), "decode_host_syncs": syncs,
           "peak_memory_gb": peak_gb, "alloc_retries": retries, "launches": launches}
    print("audio decode", json.dumps(rec), flush=True)
    if any(launches.values()):
        raise AssertionError(f"audio decode: kernel launches {launches} (the path has none)")
    if retries:
        raise AssertionError(f"audio decode: the caching allocator retried {retries} times")
    if not scalar_equal:
        raise AssertionError("audio decode: a scalar-position step differs from the per-slot one")
    if syncs:
        raise AssertionError(f"audio decode: a decode step makes the host wait for the card "
                             f"{syncs} times")
    if max(errs) > DECODE_REL_TOL:
        raise AssertionError(f"audio decode: a step's logits are {max(errs)} of the scale from "
                             f"the forward's (> {DECODE_REL_TOL})")
    del params, cache
    return launches


def audio_train_phase() -> dict:
    """whisper-tiny at full size through ``make_train_step``
    (``collectives="torrent"``, K = 2, rs_ag; the ranks' rows split along
    ``parallel.sharding.batch_pspecs``' axes) on 4 virtual DP ranks of 4
    sequences of 448 decoder tokens (whisper's target length; Markov
    tokens) with their (16, 1500, 384) bf16 frames (random from the
    step's seed), reference attention. First, on the first batch from
    the init: the 4-rank Torrent reduction's loss and grads (the step's
    ``grad_fn``) against one rank's ``make_grad_fn`` on the whole batch,
    within ``TRAIN_LOSS_REL_TOL`` and ``TRAIN_GRAD_REL_TOL`` (every
    leaf's error norm over its grad norm), and a quarter batch's grads
    beyond the latter (the check tells the batch apart). Then 6 exact
    steps and 6 of int8 + error feedback, from that init (driven by
    ``drive_trainer``): finite losses, the first step's within
    ``TRAIN_LOSS_REL_TOL`` of the one-rank loss, the last below the
    first; every param leaf moved; each step's wire bytes equal to
    ``program_wire_bytes``; the int8 run's payload a quarter of the exact
    run's wire bytes (up to each frame's rounding) plus its scales; no
    allocator retry; no kernel launch."""
    import types

    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.core.topology import MeshTopology
    from repro_torch.data.pipeline import MarkovSource, make_device_placer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import (
        ef_residual_init, split_batch, torrent_grad_reduce)
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = C.get_config("whisper-tiny")
    dp, B, S, steps, K = 4, 16, 448, 6, 2
    mesh = make_host_mesh(data=dp)
    specs = sharding.batch_pspecs(cfg, C.Shape("audio_train", "train", S, B))
    source = MarkovSource(vocab=cfg.vocab_size, seq_len=S, global_batch=B, seed=1)
    place = make_device_placer("cuda")

    def device_batch(i):
        frames = audio_frames(torch.Generator(device="cuda").manual_seed(100 + i), B, cfg)
        return {**place(source.batch(i)), "enc_frames": frames}

    def init_params():
        return T.model_init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")

    def worst_leaf(got, want):
        return max(float((a - b).norm() / b.norm()) for a, b in zip(leaves(got), leaves(want)))

    reset_launches()
    params, batch = init_params(), device_batch(0)
    one_rank = make_grad_fn(cfg, loss_chunks=8)
    g1, m1 = one_rank(params, batch)
    g4, m4 = torrent_grad_reduce(make_grad_fn(cfg, loss_chunks=8), mesh, specs,
                                 num_chains=K, algo="rs_ag")(params, batch)
    quarter, _ = one_rank(params, split_batch(batch, dp, 0, specs))
    ref_loss = float(m1["loss"])
    check = {"loss_one_rank": ref_loss, "loss_rel": abs(float(m4["loss"]) / ref_loss - 1),
             "grad_rel_worst_leaf": worst_leaf(g4, g1),
             "quarter_batch_grad_rel_worst_leaf": worst_leaf(quarter, g1)}
    print("audio train: 4 ranks vs one rank on the whole batch", json.dumps(check), flush=True)
    if not (check["loss_rel"] <= TRAIN_LOSS_REL_TOL
            and check["grad_rel_worst_leaf"] <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"audio train: the 4-rank reduction's loss or grads miss one rank's "
                             f"on the whole batch ({TRAIN_LOSS_REL_TOL}, {TRAIN_GRAD_REL_TOL}): "
                             f"{check}")
    if check["quarter_batch_grad_rel_worst_leaf"] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"audio train: a quarter batch's grads pass the grad check: {check}")
    del params, batch, g1, g4, quarter
    torch.cuda.empty_cache()
    runs = {}
    for name, compress in (("exact", False), ("int8_ef", True)):
        spans = mem_spans()
        params = init_params()
        init = [p.clone() for p in leaves(params)]
        state = {"params": params, "opt": adamw.init(params)}
        if compress:
            state["ef"] = ef_residual_init(params, dp)
        step_fn = make_train_step(
            cfg, adamw.OptConfig(peak_lr=5e-4, warmup_steps=2, decay_steps=steps),
            collectives="torrent", num_chains=K, ar_algo="rs_ag", compress_grads=compress,
            error_feedback=compress, mesh=mesh, loss_chunks=8, spans=spans)
        tr = types.SimpleNamespace(state=state, step_fn=step_fn, _device_batch=device_batch)
        rec = drive_trainer(f"audio train {name}", tr, spans, steps, B * S, MeshTopology(dp, 1))
        moved = sum(not torch.equal(a, b) for a, b in zip(init, leaves(tr.state["params"])))
        rec["leaves_moved"] = [moved, len(init)]
        losses = rec["losses"]
        if (not np.isfinite(losses).all() or moved != len(init) or losses[-1] >= losses[0]
                or abs(losses[0] / ref_loss - 1) > TRAIN_LOSS_REL_TOL):
            raise AssertionError(f"audio train {name}: losses {losses} (the first within "
                                 f"{TRAIN_LOSS_REL_TOL} of one rank's {ref_loss}, the last "
                                 f"below it), {moved} of {len(init)} param leaves moved")
        runs[name] = rec
        del tr, state, params, init
        torch.cuda.empty_cache()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"audio train: kernel launches {launches} (the path has none)")
    exact = runs["exact"]["wire_bytes_per_step"]
    q8, scales = runs["int8_ef"]["wire_bytes_per_step"], runs["int8_ef"]["wire_scale_bytes_per_step"]
    print(f"audio train: wire bytes per step exact {exact} int8 {q8} (scales {scales}, payload "
          f"x 4 / exact {4 * (q8 - scales) / exact:.6f}); tokens/s exact "
          f"{runs['exact']['tokens_per_s']:.1f} int8+ef {runs['int8_ef']['tokens_per_s']:.1f}; "
          f"kernel launches {launches}", flush=True)
    # each int8 frame is its f32 frame's bytes / 4, rounded up, + 4 B
    if not 0 <= 4 * (q8 - scales) - exact < scales:
        raise AssertionError(f"audio train: int8 wire {q8} B (scales {scales}) is not a quarter "
                             f"of the exact {exact} B plus its scales")
    return launches


# JAX's smoke shapes (tests/test_steps_and_dryrun.py), registered in the
# port's SHAPES while the cell phase runs its smoke cells
CELL_SMOKE_SHAPES = {"train": ("train_smoke", 32, 4), "prefill": ("prefill_smoke", 32, 2),
                     "decode": ("decode_smoke", 64, 4)}
ASSIGNED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CELL_VARIANTS = ("k2", "k-auto", "int8-ar", "bucketed")


@contextlib.contextmanager
def registered(table: dict, key, value):
    """``table[key] = value`` inside the block (a shape or a variant the
    phase adds to the port's registries), removed after it."""
    if key in table:
        raise KeyError(f"{key!r} is already registered")
    table[key] = value
    try:
        yield
    finally:
        del table[key]


def active_params(cfg, total: int) -> int:
    """Parameters a token uses: all of them, less the routed experts it
    is not sent to (top-k of them, and the shared ones, are), as the
    JAX package's dry run counts them."""
    if not cfg.num_experts:
        return total
    moe_layers = sum(1 for i in range(cfg.num_layers) if cfg.layer_spec(i).ffn == "moe")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    return total - moe_layers * per_expert * (cfg.num_experts - cfg.moe_top_k)


def abstract_cells() -> int:
    """Every applicable (arch × assigned shape) cell at full width, built
    by ``build_cell`` on a 4-rank data mesh with meta tensors: no device
    memory may move. One line a cell: total and active params, the
    args' bytes and the model FLOPs of one step."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import leaves

    mesh = make_host_mesh(data=4)
    before = torch.cuda.memory_allocated()
    n = 0
    for arch in C.ARCHS:
        for name in ASSIGNED_SHAPES:
            if not C.applicable(arch, name)[0]:
                continue
            cell = build_cell(arch, name, mesh, collectives="torrent")
            args = leaves(cell.args)
            if any(t.device.type != "meta" for t in args):
                raise AssertionError(f"cell {arch} {name}: an arg is not a meta tensor")
            total = sum(p.numel() for p in leaves(cell.args[0]))
            active = active_params(cell.cfg, total)
            sh = cell.shape
            tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
            print(f"cell {arch} {name}: " + json.dumps({
                "kind": sh.kind, "params": total, "active_params": active,
                "arg_bytes": sum(t.numel() * t.element_size() for t in args),
                "model_flops": model_flops(active, tokens, sh.kind),
                "donate": list(cell.donate_argnums)}), flush=True)
            n += 1
    moved = torch.cuda.memory_allocated() - before
    if moved or n != 40 - 7:
        raise AssertionError(f"cells: {n} built (33 expected), device memory moved {moved} B")
    return n


def smoke_cells() -> dict:
    """Every arch's train, prefill and decode cell at its smoke config
    and JAX's smoke shapes, built by ``build_cell`` on the card (2 data
    ranks, Torrent reduction) and run once: every output finite, the
    train step moves every param, no allocator retry, no kernel launch
    (every arch's cells use reference attention)."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import leaves

    mesh = make_host_mesh(data=2)
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_launches()
    out = {}
    with contextlib.ExitStack() as stack:
        for kind, (name, seq, batch) in CELL_SMOKE_SHAPES.items():
            stack.enter_context(registered(C.SHAPES, name, C.Shape(name, kind, seq, batch)))
        for arch in C.ARCHS:
            rec = {}
            for kind, (name, _, _) in CELL_SMOKE_SHAPES.items():
                cell = build_cell(arch, name, mesh, collectives="torrent", smoke=True,
                                  device="cuda")
                before = [p.clone() for p in leaves(cell.args[0])] if kind == "train" else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cell.step_fn(*cell.args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                finite = all(bool(torch.isfinite(t).all()) for t in leaves(res)
                             if t.dtype.is_floating_point)
                if kind == "train":
                    moved = sum(not torch.equal(a, b) for a, b in zip(before, leaves(res[0])))
                    ok = finite and moved == len(before)
                    rec[kind] = {"loss": float(res[2]["loss"]), "moved": [moved, len(before)],
                                 "ms": ms}
                elif kind == "prefill":
                    ok = finite and tuple(res[0].shape) == (cell.shape.global_batch,
                                                            cell.cfg.vocab_size)
                    rec[kind] = {"logits_absmax": float(res[0].abs().max()), "ms": ms}
                else:
                    tok = res[0]
                    ok = finite and bool(((tok >= 0) & (tok < cell.cfg.vocab_size)).all())
                    rec[kind] = {"tokens": tok.tolist(), "ms": ms}
                if not ok:
                    raise AssertionError(f"cell {arch} {kind}: {rec[kind]} (finite {finite})")
                del cell, res, before
            print(f"cell smoke {arch}: {json.dumps(rec)}", flush=True)
            out[arch] = rec
    launches = read_launches()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    if retries or any(launches.values()):
        raise AssertionError(f"cell smoke: {retries} allocator retries, launches {launches}")
    return out


def variant_cells() -> dict:
    """yi-6b's smoke train cell under the ``k2``, ``k-auto``,
    ``int8-ar`` and ``bucketed`` variants, one step each on 4 data ranks
    (on 2 a ring takes one chain whatever K asks): the executor's wire
    bytes equal the byte model's, and for ``bucketed`` the modeled
    overlap's ``total_wire_bytes`` too."""
    import torch
    from repro_torch import configs as C
    from repro_torch.core import chainwrite as cw
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import modeled_train_overlap
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import leaves

    name, seq, batch = CELL_SMOKE_SHAPES["train"]
    dp = 4
    out = {}
    with registered(C.SHAPES, name, C.Shape(name, "train", seq, batch)):
        for variant in CELL_VARIANTS:
            cell = build_cell("yi-6b", name, make_host_mesh(data=dp), collectives="torrent",
                              smoke=True, variant=variant, device="cuda")
            cw.wire_counter.reset()
            res = cell.step_fn(*cell.args)
            torch.cuda.synchronize()
            rec = {"num_chains": cell.num_chains, "compress_grads": cell.compress_grads,
                   "bucket_bytes": cell.bucket_bytes, "loss": float(res[2]["loss"]),
                   "wire_bytes": cw.wire_counter.bytes,
                   "modeled_wire_bytes": cw.wire_counter.modeled_bytes()}
            if cell.bucket_bytes is not None:
                rec["overlap_model_wire_bytes"] = modeled_train_overlap(
                    leaves(cell.args[0]), dp, seq * batch // dp, bucket_bytes=cell.bucket_bytes,
                    num_chains=cell.num_chains,
                    wire_dtype="int8" if cell.compress_grads else None)["total_wire_bytes"]
            print(f"cell variant {variant}: {json.dumps(rec)}", flush=True)
            if not (rec["wire_bytes"] == rec["modeled_wire_bytes"] > 0
                    and rec.get("overlap_model_wire_bytes", rec["wire_bytes"]) == rec["wire_bytes"]
                    and torch.isfinite(res[2]["loss"])):
                raise AssertionError(f"cell variant {variant}: {rec}")
            out[variant] = rec
            del cell, res
    return out


def family_train(arch: str, layers: int, B: int, S: int, steps: int = 4) -> dict:
    """``arch`` at full width, depth cut to ``layers`` (a variant of the
    phase's own), through the train step of its ``build_cell`` train
    cell on the card: 2 virtual ranks, Torrent rs_ag with K = 2 asked
    for (a 2-rank ring runs one chain), exact wire, the cell's AdamW
    (``OptConfig()``: the first steps of its warmup). First, on the first batch from the init, the 2-rank
    reduction's loss and grads against one rank's on the whole batch
    (``TRAIN_LOSS_REL_TOL``, ``TRAIN_GRAD_REL_TOL``; every grad finite)
    and half a batch's beyond the latter; then ``steps`` steps on that
    batch of Markov tokens (a vision-language model gets their rows of
    its own embedding table, as text, at text positions; one batch, so
    a step in the grads' direction must lower the loss): losses finite
    and falling, wire bytes equal to the model's, every param leaf moved
    and finite, no allocator retry."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.core import chainwrite as cw
    from repro_torch.data.pipeline import MarkovSource, make_device_placer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import VARIANTS, build_cell, make_grad_fn
    from repro_torch.parallel.collectives import split_batch, torrent_grad_reduce
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_launches()
    name, variant, dp = f"{arch}_train", f"depth{layers}", 2
    with registered(C.SHAPES, name, C.Shape(name, "train", S, B)), \
            registered(VARIANTS, variant, {"num_layers": layers}):
        cell = build_cell(arch, name, make_host_mesh(data=dp), collectives="torrent",
                          num_chains=2, variant=variant, device="cuda")
    cfg, (params, opt, _), specs = cell.cfg, cell.args, cell.in_specs[2]
    source = MarkovSource(vocab=cfg.vocab_size, seq_len=S, global_batch=B, seed=1)
    place = make_device_placer("cuda")

    def batch_at(i):
        b = place(source.batch(i))
        if cfg.family != "vlm":
            return b
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(3, B, S).contiguous()
        embeds = params["embed"]["table"][b["tokens"].long()].to(torch.bfloat16)
        return {"embeds": embeds, "positions": pos, "labels": b["labels"]}

    def worst_leaf(got, want):
        return max(float((a - b).norm() / b.norm()) for a, b in zip(leaves(got), leaves(want))
                   if b.norm() > 0)

    batch = batch_at(0)
    grad_fn = make_grad_fn(cfg)
    g1, m1 = grad_fn(params, batch)
    finite = all(bool(torch.isfinite(g).all()) for g in leaves(g1))
    g2, m2 = torrent_grad_reduce(grad_fn, cell.mesh, specs, num_chains=2)(params, batch)
    ref_loss = float(m1["loss"])
    check = {"params": sum(p.numel() for p in leaves(params)), "loss_one_rank": ref_loss,
             "loss_rel": abs(float(m2["loss"]) / ref_loss - 1),
             "grad_rel_worst_leaf": worst_leaf(g2, g1), "grads_finite": finite}
    del g2
    half, _ = grad_fn(params, split_batch(batch, dp, 0, specs))
    check["half_batch_grad_rel_worst_leaf"] = worst_leaf(half, g1)
    del g1, half, batch
    torch.cuda.empty_cache()
    print(f"{arch} train: {dp} ranks vs one rank on the whole batch {json.dumps(check)}",
          flush=True)
    if not (finite and check["loss_rel"] <= TRAIN_LOSS_REL_TOL
            and check["grad_rel_worst_leaf"] <= TRAIN_GRAD_REL_TOL
            and check["half_batch_grad_rel_worst_leaf"] > TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"{arch} train: the {dp}-rank reduction misses one rank's grads, "
                             f"or a grad is not finite, or half a batch passes: {check}")
    init = [p.clone() for p in leaves(params)]
    losses, walls, wire = [], [], []
    batch = batch_at(0)
    for _ in range(steps):
        cw.wire_counter.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = cell.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        wire.append((cw.wire_counter.bytes, cw.wire_counter.modeled_bytes()))
    moved = sum(not torch.equal(a, b) for a, b in zip(init, leaves(params)))
    finite = all(bool(torch.isfinite(p).all()) for p in leaves(params))
    rec = {"layers": layers, "batch": [B, S], "losses": losses, "step_wall_s": walls,
           "median_step_s": float(np.median(walls)),
           "tokens_per_s": B * S / float(np.median(walls)),
           "wire_bytes_per_step": wire[-1][0], "leaves_moved": [moved, len(init)],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0,
           "launches": read_launches()}
    print(f"{arch} train: {json.dumps(rec)}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and finite
            and moved == len(init) and all(a == b > 0 for a, b in wire)
            and rec["alloc_retries"] == 0 and not any(rec["launches"].values())):
        raise AssertionError(f"{arch} train: {rec}")
    del cell, params, opt, init
    gc.collect()
    torch.cuda.empty_cache()
    return {**check, **rec}


def cell_phase() -> dict:
    """The cell layer: every assigned cell built abstractly, every
    arch's three smoke cells and yi-6b's variant cells run on the card
    from ``build_cell``, and mamba2-2.7b (4 of 64 layers) and
    qwen2-vl-7b (2 of 28) trained at full width through their train
    cells."""
    t0 = time.perf_counter()
    n = abstract_cells()
    t1 = time.perf_counter()
    smoke = smoke_cells()
    variants = variant_cells()
    t2 = time.perf_counter()
    trains = {"mamba2-2.7b": family_train("mamba2-2.7b", 4, 8, 512),
              "qwen2-vl-7b": family_train("qwen2-vl-7b", 2, 4, 512)}
    t3 = time.perf_counter()
    print(f"cell phase: {n} abstract cells {t1 - t0:.2f}s, {len(smoke)} x 3 smoke cells + "
          f"{len(variants)} variants {t2 - t1:.2f}s, ssm and vlm training {t3 - t2:.2f}s",
          flush=True)
    return {"smoke": smoke, "variants": variants, "train": trains}

# the losses of the process form against the stacked Trainer's on the
# card: exact wire and xla (the same per-rank grads and a bit-exact
# reduction, two ranks' sum being one rounding in either order: expect
# 0, and the params bit for bit) and int8 + EF (each process updates its
# ZeRO-1 block from its own reduced row, where the stacked form hands
# every rank row 0; 3e-4 on the CPU after 2 steps, tests/test_torch_dist.py)
DIST_LOSS_TOL = {"exact": 1e-5, "int8_ef": 2e-3, "xla": 1e-5}
DIST_TRAIN = dict(arch="yi-6b", smoke=False, layers=2, steps=2, global_batch=8, seq_len=512,
                  peak_lr=5e-4, warmup_steps=2, collectives="torrent", num_chains=1,
                  bucket_bytes=25 << 20, loss_chunks=8, seed=0)


def dist_executor_rank(rank, world, device, case_list):
    """One rank of the dist phase's executor check (a spawned process)."""
    import torch.distributed as dist
    import _dist_cases as dc
    from repro_torch.core import chainwrite_dist as cwd

    return {"transport": cwd.transport(dist.group.WORLD, device),
            "cases": dc.executor_rank(rank, world, device, case_list)}


# the dist phase's Trainer runs: (name, compress_grads, collectives);
# the xla run reduces with the backend's all-reduce and has no buckets
DIST_RUNS = (("exact", False, "torrent"), ("int8_ef", True, "torrent"), ("xla", False, "xla"))


def dist_run_config(name: str, compress: bool, collectives: str) -> dict:
    """``DIST_TRAIN`` for one of ``DIST_RUNS``."""
    return dict(DIST_TRAIN, compress_grads=compress, collectives=collectives,
                bucket_bytes=DIST_TRAIN["bucket_bytes"] if collectives == "torrent" else None)


def leaf_digests(tree) -> list[str]:
    """A blake2b digest of every leaf's bytes (equal digests: equal bits)."""
    import hashlib
    import torch
    from repro_torch.tree import leaves

    return [hashlib.blake2b(t.detach().contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            for t in leaves(tree)]


def dist_train_rank(rank, world, device, stacked_digests):
    """One rank of the process-form training (a spawned process): the
    first step's reduced grads checked leaf by leaf, then 2 steps of
    each of ``DIST_RUNS`` through the process-form ``Trainer``, with
    ZeRO-1 over ``data = 2``: the rank's moment bytes against the whole
    moments', the param gather's bytes against their count, and (exact
    and xla) the params' digests after the steps against the stacked
    ``Trainer``'s (``stacked_digests``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import chainwrite as cw
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as col
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    reset_launches()
    out = {"transport": cwd.transport(dist.group.WORLD, device)}
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for name, compress, collectives in DIST_RUNS:
        t0 = time.perf_counter()
        spans = Spans()
        tr = Trainer(TrainConfig(**dist_run_config(name, compress, collectives)), device=device,
                     spans=spans)
        group = tr.mesh.group("data")
        init_s = time.perf_counter() - t0
        if name == "exact":
            # the first step's grads: the stacked reduction of the two
            # ranks' grads (all-gathered by the executor) leaf by leaf,
            # against this process's bucketed reduction, which writes
            # the mean into the grads' own buffers
            raw, _ = make_grad_fn(tr.cfg, loss_chunks=DIST_TRAIN["loss_chunks"])(
                tr.state["params"], tr._device_batch(0))
            raw = leaves(raw)
            stacked_reduce = col.make_stacked_reduce(make_host_mesh(data=world), num_chains=1)
            want = []
            for g in raw:
                both = cw.chain_all_gather(g, group=group)
                want.append(stacked_reduce([both])[0])
                del both
            reduced = col.make_stacked_reduce(tr.mesh, num_chains=1,
                                              bucket_bytes=DIST_TRAIN["bucket_bytes"])(
                [g.unsqueeze(0) for g in raw])
            unequal = [i for i, (a, b) in enumerate(zip(want, reduced)) if not torch.equal(a, b)]
            out["grad_check"] = {"leaves": len(raw), "unequal": unequal,
                                 "params": sum(g.numel() for g in raw)}
            del raw, reduced, want
            torch.cuda.empty_cache()
        params = leaves(tr.state["params"])
        param_bytes = sum(p.numel() * p.element_size() for p in params)
        moment_bytes = sum(m.numel() * m.element_size() for key in ("mu", "nu")
                           for m in leaves(tr.state["opt"][key]))
        split_bytes = sum(p.numel() * p.element_size() for p, m in
                          zip(params, leaves(tr.state["opt"]["mu"])) if m.shape != p.shape)
        torch.cuda.reset_peak_memory_stats()
        losses, walls, span_ms, wire, gathered = [], [], [], [], []
        for i in range(DIST_TRAIN["steps"]):
            cwd.wire_counter.reset()
            adamw.gather_counter.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer_step(tr, i)["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            span_ms.append({k: [round(v, 3) for v in vs] for k, vs in spans.read().items()})
            wire.append((cwd.wire_counter.bytes, cwd.wire_counter.modeled_bytes(),
                         cwd.wire_counter.program_bytes()))
            gathered.append(adamw.gather_counter.bytes)
        rec = {"collectives": collectives, "losses": losses, "step_wall_s": walls,
               "init_s": init_s, "median_step_s": float(np.median(walls)),
               "spans_ms": span_ms[-1],
               "param_bytes": param_bytes, "moment_bytes": moment_bytes,
               "moment_share_of_whole": moment_bytes / (2 * param_bytes),
               "gather_bytes_per_step": gathered[-1],
               "gather_bytes_count": split_bytes * (world - 1) // world,
               "gather_equal_count": all(b == split_bytes * (world - 1) // world
                                         for b in gathered),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if collectives == "torrent":
            rec.update({"wire_bytes_per_step": wire[-1][0],
                        "modeled_wire_bytes_per_step": wire[-1][1],
                        "program_wire_bytes_per_step": wire[-1][2],
                        "wire_equal_model": all(a == b == c for a, b, c in wire)})
        if name in stacked_digests:
            rec["params_bit_equal_stacked"] = leaf_digests(tr.state["params"]) == \
                stacked_digests[name]
        out[name] = rec
        del tr, params
        gc.collect()
        torch.cuda.empty_cache()
    out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    out["launches"] = read_launches()
    return out


# expert parallelism across the processes: deepseek-moe-16b at full
# width, 2 of 28 layers (1 dense + 1 MoE), one train step with the
# remat'd recompute (its exchanges run on the autograd engine's thread)
DIST_EP = dict(arch="deepseek-moe-16b", layers=2, global_batch=8, seq_len=512, loss_chunks=8,
               num_chains=1, remat="dots")
# its step against the stacked joint step: the bounds of
# tests/test_torch_dist.py::test_ep_train_step_matches_stacked_joint_step
# (bf16 grads of the batch run as one joint forward or as one forward a
# rank; equal bit for bit on the CPU): the loss, each leaf's update
# difference over the update's largest element, the updates' cosine
DIST_EP_TOL = {"loss": 1e-3, "update_rel": 5e-2, "cosine_min": 0.999}


def dist_ep_rank(rank, world, device):
    """One rank of the dist phase's expert-parallel check (a spawned
    process): one train step of ``DIST_EP``'s model with
    ``moe_ep_dispatch`` on the process form, each MoE layer exchanging
    this rank's tokens with the other rank's over the group, from the
    params of seed 0 and batch 0 (a linear AdamW step, as the test's).
    Rank 0 first runs the stacked joint step (both ranks in one forward)
    from the same params and batch, alone on the card while rank 1 waits
    at a barrier, and keeps its update on the host; then it holds the
    process form's update against it leaf by leaf. Every rank's update
    must equal rank 0's bit for bit (the exact wire)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import _dist_cases as dc
    from repro_torch import configs as C
    from repro_torch.core import chainwrite as cw
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.data.pipeline import MarkovSource, make_device_placer, rank_slice
    from repro_torch.launch.mesh import make_host_mesh, make_process_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(C.get_config(DIST_EP["arch"]), moe_ep_dispatch=True,
                              num_layers=DIST_EP["layers"])
    source = MarkovSource(cfg.vocab_size, DIST_EP["seq_len"], DIST_EP["global_batch"], seed=1)
    place = make_device_placer(device)

    def init():
        return T.model_init(torch.Generator(device=device).manual_seed(0), cfg, device)

    def step_on(mesh):
        return make_train_step(cfg, adamw.OptConfig(**dc.LINEAR_ADAMW), collectives="torrent",
                               mesh=mesh, loss_chunks=DIST_EP["loss_chunks"],
                               num_chains=DIST_EP["num_chains"], remat=DIST_EP["remat"])

    def run(step, batch, mesh):
        p = init()
        p0 = [t.cpu() for t in leaves(p)]
        # the process form's moments are its ZeRO-1 blocks (whole on the stacked view)
        opt = adamw.init(p, specs=shd.train_state_specs(cfg, mesh)["opt"], mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, _, m = step(p, opt, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        return leaves(new_p), p0, loss, wall

    out = {"transport": cwd.transport(dist.group.WORLD, device)}
    ref = None
    if rank == 0:
        stacked = make_host_mesh(data=world)
        new_p, p0, loss, wall = run(step_on(stacked), place(source.batch(0)), stacked)
        ref = {"loss": loss, "update": [(a - b.to(device)).cpu() for a, b in zip(new_p, p0)]}
        out["stacked"] = {"loss": loss, "step_wall_s": wall,
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del new_p, p0
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    mesh = make_process_mesh()
    step = step_on(mesh)
    batch = place(source.batch(0, host_slice=rank_slice(DIST_EP["global_batch"], world, rank)))
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_launches()
    cwd.wire_counter.reset()
    new_p, p0, loss, wall = run(step, batch, mesh)
    launches = read_launches()
    ep_bytes = sum(n * cwd.sent_wire_bytes(p, size, frames, r)
                   for (p, size, frames, r), n in cwd.wire_counter.runs.items()
                   if p.collective == "all_to_all")
    out["process"] = {
        "loss": loss, "step_wall_s": wall, "wire_bytes": cwd.wire_counter.bytes,
        "modeled_wire_bytes": cwd.wire_counter.modeled_bytes(), "ep_wire_bytes": ep_bytes,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0,
        "launches": launches, "params": sum(t.numel() for t in new_p)}
    group = mesh.group("data")
    unequal, errs, coss = [], [], []
    for i, (a, b) in enumerate(zip(new_p, p0)):
        if not all(torch.equal(x, a) for x in cw.chain_all_gather(a, group=group)):
            unequal.append(i)
        if ref is not None:
            db = (a - b.to(device)).double()
            da = ref["update"][i].to(device).double()
            errs.append(float((da - db).abs().max() / da.abs().max()))
            coss.append(float((da * db).sum() / ((da * da).sum() * (db * db).sum()).sqrt()))
            del da, db
    out["ranks_unequal_leaves"] = unequal
    if ref is not None:
        # np.max/np.min keep a NaN, which then fails the bounds
        out["vs_stacked"] = {"loss_diff": abs(loss - ref["loss"]),
                             "max_update_rel_err": float(np.max(errs)),
                             "min_cosine": float(np.min(coss)), "leaves": len(new_p)}
    return out


def dist_phase() -> dict:
    """The process form on the card (phase 17 of the module docstring)."""
    import numpy as np
    import torch
    import _dist_cases as dc
    from repro_torch.core import chainwrite as cw
    from repro_torch.launch.dist import spawn
    from repro_torch.launch.train import TrainConfig, Trainer

    # 1. the executor's matrix on 4 ranks sharing the card; two of them
    # at a size that makes the staged frames megabytes
    L = 4
    cases = dc.cases(L, Ks=(1, 2), seeds=(0, 1), full=False)
    for wire in (None, "int8"):
        c = dict(kind="all_reduce", K=2, seed=1, algo="rs_ag", wire=wire, n=1 << 18)
        c["name"] = f"all_reduce-large-{wire}"
        cases.append(c)
    t0 = time.perf_counter()
    ranks = spawn(dist_executor_rank, L, backend="gloo", device="cuda", timeout_s=300,
                  args=(cases,))
    spawn_s = time.perf_counter() - t0
    bad = dc.executor_mismatches(cases, ranks, "cuda")
    transport = {r["transport"] for r in ranks}
    print(f"dist executor: {json.dumps({'ranks': L, 'cases': len(cases), 'bit_exact': not bad, 'transport': sorted(transport), 'spawn_and_run_s': round(spawn_s, 2)})}", flush=True)
    if bad or transport != {"gloo via pinned host"}:
        raise AssertionError(f"dist executor: {bad[:10]} transport {transport}")

    # 2. the stacked reference in this process first, then freed: its
    # ~40 GB and two ranks' ~30 GB each do not fit one card together
    gc.collect()
    torch.cuda.empty_cache()
    want, digests = {}, {}
    for name, compress, collectives in DIST_RUNS:
        tr = Trainer(TrainConfig(dp=2, **dist_run_config(name, compress, collectives)),
                     device="cuda")
        want[name] = [float(trainer_step(tr, i)["loss"]) for i in range(DIST_TRAIN["steps"])]
        if not compress:  # the ranks' params must match these bit for bit
            digests[name] = leaf_digests(tr.state["params"])
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"dist train: stacked Trainer (dp=2) losses {json.dumps(want)}; card free "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB before the spawn", flush=True)
    if free < 0.75 * total:
        raise AssertionError(f"dist train: only {free / 1e9:.2f} GB free before the spawn")
    t0 = time.perf_counter()
    ranks = spawn(dist_train_rank, 2, backend="gloo", device="cuda", timeout_s=900,
                  args=(digests,))
    wall = time.perf_counter() - t0
    for r, rec in enumerate(ranks):
        print(f"dist train rank {r}: {json.dumps(rec)}", flush=True)
    errors, zero1 = {}, {}
    for name in want:
        got = ranks[0][name]["losses"]
        errors[name] = max(abs(a - b) for a, b in zip(got, want[name]))
        recs = [rk[name] for rk in ranks]
        # ZeRO-1 over data = 2: half the whole moments a rank, the gather
        # as counted, the params bit for bit the stacked run's
        zero1[name] = {"moment_share_of_whole": [r_["moment_share_of_whole"] for r_ in recs],
                       "gather_bytes_per_step": recs[0]["gather_bytes_per_step"],
                       "params_bit_equal_stacked": [r_.get("params_bit_equal_stacked")
                                                    for r_ in recs]}
        if not (all(rk[name]["losses"] == got for rk in ranks) and errors[name] <= DIST_LOSS_TOL[name]
                and all(r_.get("wire_equal_model", True) for r_ in recs)
                and all(r_["moment_share_of_whole"] == 0.5 and r_["gather_equal_count"]
                        for r_ in recs)
                and all(r_.get("params_bit_equal_stacked", True) for r_ in recs)
                and np.isfinite(got).all()):
            raise AssertionError(f"dist train {name}: losses {got} vs stacked {want[name]}, "
                                 f"ZeRO-1 {zero1[name]}")
    launches = {k: sum(rk["launches"][k] for rk in ranks) for k in ranks[0]["launches"]}
    checks = [rk["grad_check"] for rk in ranks]
    if any(c["unequal"] for c in checks) or any(rk["alloc_retries"] for rk in ranks) \
            or any(launches.values()) or {rk["transport"] for rk in ranks} != {"gloo via pinned host"}:
        raise AssertionError(f"dist train: grad checks {checks}, retries "
                             f"{[rk['alloc_retries'] for rk in ranks]}, launches {launches}")
    print(f"dist train: {json.dumps({'ranks': 2, 'first_step_leaves_bit_exact': checks[0]['leaves'], 'params': checks[0]['params'], 'max_loss_diff_vs_stacked': errors, 'tolerance': DIST_LOSS_TOL, 'zero1': zero1, 'phase_wall_s': round(wall, 2), 'launches': launches})}", flush=True)

    # 3. expert parallelism across the processes, against the stacked
    # joint step that rank 0 runs first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(dist_ep_rank, 2, backend="gloo", device="cuda", timeout_s=900)
    wall = time.perf_counter() - t0
    for r, rec in enumerate(ranks):
        print(f"dist ep rank {r}: {json.dumps(rec)}", flush=True)
    procs = [rk["process"] for rk in ranks]
    vs = ranks[0]["vs_stacked"]
    ep_launches = {k: sum(p_["launches"][k] for p_ in procs) for k in procs[0]["launches"]}
    if not (vs["loss_diff"] <= DIST_EP_TOL["loss"]
            and vs["max_update_rel_err"] <= DIST_EP_TOL["update_rel"]
            and vs["min_cosine"] >= DIST_EP_TOL["cosine_min"]
            and not any(rk["ranks_unequal_leaves"] for rk in ranks)
            and all(p_["ep_wire_bytes"] > 0 and p_["wire_bytes"] == p_["modeled_wire_bytes"]
                    for p_ in procs)
            and all(np.isfinite(p_["loss"]) for p_ in procs)
            and not any(p_["alloc_retries"] for p_ in procs)
            and not any(ep_launches.values())
            and {rk["transport"] for rk in ranks} == {"gloo via pinned host"}):
        raise AssertionError(f"dist ep: {vs} vs {DIST_EP_TOL}, ranks {ranks}")
    print(f"dist ep: {json.dumps({'ranks': 2, 'arch': DIST_EP['arch'], 'layers': DIST_EP['layers'], 'params': procs[0]['params'], 'vs_stacked_joint_step': vs, 'tolerance': DIST_EP_TOL, 'ep_wire_bytes_per_rank': [p_['ep_wire_bytes'] for p_ in procs], 'phase_wall_s': round(wall, 2), 'launches': ep_launches})}", flush=True)
    return {"train_launches": launches, "ep_launches": ep_launches}



# tensor parallelism on the card: yi-6b at full width, 2 of 32 layers,
# TP = 2 over two gloo ranks sharing the card, 4 x 512 tokens a step
TP_TRAIN = dict(arch="yi-6b", smoke=False, layers=2, steps=2, global_batch=4, seq_len=512,
                peak_lr=5e-4, warmup_steps=2, collectives="torrent", num_chains=1,
                loss_chunks=8, seed=0)
# TP = 2 against the stacked TP = 1 Trainer from the same seed: a rank
# rounds its bf16 partial sums before the all-reduce, so the first
# step's grads differ by bf16 rounding (measured on the CPU at smoke
# size: 1.8e-2 of a leaf's max; with f32 compute 8.4e-7,
# tests/test_torch_tp.py) and so do the losses (6.2e-4 after 6 steps)
TP_GRAD_TOL = 3e-2
TP_LOSS_TOL = 2e-3


def tp_train_rank(rank, world, device, ref_dir):
    """One rank of the tp phase (a spawned process): the process-form
    ``Trainer`` at ``tp=world``. Its first step's grads gathered leaf by
    leaf against the stacked Trainer's saved in ``ref_dir`` (rank 0
    compares), then 3 exact and 3 int8 + EF steps: losses, walls,
    spans, the model group's payload bytes against
    ``parallel.tp.modeled_tp_bytes``, the whole leaves (params and AdamW
    moments) bit for bit across the TP ranks after every step, peak
    memory (after the init and of the steps) and allocator retries."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    reset_launches()
    out = {"transport": cwd.transport(dist.group.WORLD, device)}
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for name, compress in (("exact", False), ("int8_ef", True)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        spans = Spans()
        tr = Trainer(TrainConfig(tp=world, compress_grads=compress, **TP_TRAIN),
                     device=device, spans=spans)
        mesh, group = tr.mesh, tr.mesh.group("model")
        rec = {"init_s": time.perf_counter() - t0,
               "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "state_memory_gb": torch.cuda.memory_allocated() / 1e9}
        pspecs = tr.specs["params"]
        whole = [not shd.is_split(sp, mesh) for sp in leaves(tr.specs)]
        if name == "exact":
            with hints.set_mesh(mesh):
                grads, _ = make_grad_fn(tr.cfg, loss_chunks=TP_TRAIN["loss_chunks"])(
                    tr.state["params"], tr._device_batch(0))
            errs = []
            for i, (g, sp) in enumerate(zip(leaves(grads), leaves(pspecs))):
                full = shd.gather_tree(g, sp, mesh)
                if rank == 0:
                    want = torch.load(f"{ref_dir}/{i}.pt", map_location=device)
                    errs.append(float((full - want).abs().max() / want.abs().max()))
                    del want
                del full
            del grads
            torch.cuda.empty_cache()
            out["grad_check"] = {"leaves": len(errs), "max_rel_err": errs}
        torch.cuda.reset_peak_memory_stats()
        tokens = TP_TRAIN["global_batch"] * TP_TRAIN["seq_len"] // mesh.shape["data"]
        model = tpm.modeled_tp_bytes(tr.cfg, tokens, world)
        losses, walls, span_ms, tp_bytes, equal = [], [], [], [], []
        for i in range(TP_TRAIN["steps"]):
            tpm.tp_counter.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer_step(tr, i)["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            tp_bytes.append(dict(tpm.tp_counter.bytes))
            ms = spans.read()
            span_ms.append({k: round(sum(v), 3) if k == "tp_comm" else [round(x, 3) for x in v]
                            for k, v in ms.items()})
            span_ms[-1]["tp_comm_calls"] = len(ms.get("tp_comm", []))
            # every leaf no spec splits (norm scales and their moments),
            # across the TP ranks: all-gathered through the host, outside
            # the counter
            same = True
            for x, w in zip(leaves(tr.state), whole):
                if w:
                    host = x.detach().reshape(-1).cpu()
                    parts = [torch.empty_like(host) for _ in range(world)]
                    dist.all_gather(parts, host, group=group)
                    same &= all(torch.equal(parts[0], q) for q in parts[1:])
            equal.append(bool(same))
        rec.update({"losses": losses, "step_wall_s": walls,
                    "median_step_s": float(np.median(walls)), "spans_ms": span_ms[-1],
                    "tp_bytes_per_step": tp_bytes[-1], "modeled_tp_bytes_per_step": model,
                    "tp_bytes_equal_model": all(b == model for b in tp_bytes),
                    "whole_leaves_bit_equal": equal,
                    "step_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[name] = rec
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    out["launches"] = read_launches()
    return out


def tp_phase() -> dict:
    """Tensor parallelism on the card (phase 18 of the module
    docstring)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.launch.dist import spawn
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves

    # 1. the stacked Trainer (TP = 1) from the same seed: the first
    # step's grads saved leaf by leaf, the losses; then freed
    gc.collect()
    torch.cuda.empty_cache()
    ref_dir = tempfile.mkdtemp(prefix="tp_ref_")
    want = {}
    try:
        for name, compress in (("exact", False), ("int8_ef", True)):
            tr = Trainer(TrainConfig(compress_grads=compress, **TP_TRAIN), device="cuda")
            if name == "exact":
                grads, _ = make_grad_fn(tr.cfg, loss_chunks=TP_TRAIN["loss_chunks"])(
                    tr.state["params"], tr._device_batch(0))
                for i, g in enumerate(leaves(grads)):
                    torch.save(g.cpu(), f"{ref_dir}/{i}.pt")
                del grads
            want[name] = [float(trainer_step(tr, i)["loss"]) for i in range(TP_TRAIN["steps"])]
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        print(f"tp train: stacked Trainer (tp=1) losses {json.dumps(want)}", flush=True)
        t0 = time.perf_counter()
        ranks = spawn(tp_train_rank, 2, backend="gloo", device="cuda", timeout_s=900,
                      args=(ref_dir,))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    for r, rec in enumerate(ranks):
        print(f"tp train rank {r}: {json.dumps(rec)}", flush=True)
    errors = {}
    for name in want:
        got = ranks[0][name]["losses"]
        errors[name] = max(abs(a - b) for a, b in zip(got, want[name]))
        if not (all(rk[name]["losses"] == got for rk in ranks) and np.isfinite(got).all()
                and errors[name] <= TP_LOSS_TOL
                and all(rk[name]["tp_bytes_equal_model"] for rk in ranks)
                and all(all(rk[name]["whole_leaves_bit_equal"]) for rk in ranks)
                and all({"fwd_bwd", "reduce", "optimizer", "tp_comm"} <= set(rk[name]["spans_ms"])
                        for rk in ranks)):
            raise AssertionError(f"tp train {name}: losses {got} vs stacked {want[name]}, "
                                 f"ranks {ranks}")
    grad_err = max(ranks[0]["grad_check"]["max_rel_err"])
    launches = {k: sum(rk["launches"][k] for rk in ranks) for k in ranks[0]["launches"]}
    if grad_err > TP_GRAD_TOL or any(rk["alloc_retries"] for rk in ranks) \
            or any(launches.values()) or {rk["transport"] for rk in ranks} != {"gloo via pinned host"}:
        raise AssertionError(f"tp train: grad err {grad_err} (tolerance {TP_GRAD_TOL}), "
                             f"retries {[rk['alloc_retries'] for rk in ranks]}, "
                             f"launches {launches}")
    print(f"tp train: {json.dumps({'ranks': 2, 'mesh': {'data': 1, 'model': 2}, 'first_step_grad_max_rel_err': grad_err, 'grad_tolerance': TP_GRAD_TOL, 'max_loss_diff_vs_tp1': errors, 'loss_tolerance': TP_LOSS_TOL, 'step_peak_memory_gb': [max(rk[n]['step_peak_memory_gb'] for n in want) for rk in ranks], 'phase_wall_s': round(wall, 2), 'launches': launches})}", flush=True)
    return {"train_launches": launches}


# tensor parallelism for the MoE, MLA, Mamba-2 and hybrid families on the
# card: full width, depth cut, TP = 2 over two gloo ranks sharing the card,
# 4 x 512 tokens a step. ``reference``: "trainer", the stacked Trainer's
# first-step grads and losses of every run; "grads", make_grad_fn's first
# step alone (jamba: a TP = 1 Trainer, 16 B a param for 3.74 B params and
# its activations, would pass the card)
TP_FAMILIES = {
    "deepseek-v2-lite-16b": dict(layers=2, runs=("exact", "int8_ef"), reference="trainer"),
    "mamba2-2.7b": dict(layers=2, runs=("exact", "int8_ef"), reference="trainer"),
    "jamba-v0.1-52b": dict(layers=2, runs=("exact",), reference="grads"),
}
TP_FAMILY_TRAIN = dict(smoke=False, steps=2, global_batch=4, seq_len=512, peak_lr=5e-4,
                       warmup_steps=2, collectives="torrent", num_chains=1, loss_chunks=8,
                       seed=0)
# the first step's grads, both sides in f32 compute: in bf16 a rank rounds
# its partial sums before the all-reduce and the families amplify it (the
# smoke mamba2-2.7b's TP = 2 grads 9.4e-2 of a leaf's max from TP = 1's,
# its TP = 1 bf16 grads 3.4e-2 from f32, on the CPU), and bf16 flips MoE
# routing; in f32 the two differ by the order of f32 sums
TP_GRAD_F32_TOL = 1e-3
# the bf16 steps' losses of a MoE model against TP = 1: the two round their
# partial sums differently, and bf16 flips near-tie top-k choices, each
# moving a token's output by O(1) (deepseek-v2-lite-16b, 4 layers, on an
# H100: 2.17e-3 at the second step, where yi-6b's TP_LOSS_TOL is 2e-3;
# the first step's bf16 loss routed as TP = 1 chose, and the f32 grads,
# show the rest is rounding: the phase prints both)
TP_MOE_LOSS_TOL = 5e-3


def _is_moe(cfg) -> bool:
    return any(s.ffn == "moe" for pattern, _ in cfg.layer_groups() for s in pattern)


def tp_family_rank(rank, world, device, arch, ref_dir):
    """One rank of the tp families phase (a spawned process): the
    process-form ``Trainer`` for ``arch`` at ``tp=world``. The first
    step's grads (routed as the reference chose, for a MoE) against this
    rank's block of the reference's leaves saved in ``ref_dir``, then
    the runs of ``TP_FAMILIES[arch]``, each with the records and checks
    of :func:`tp_train_rank`."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from _moe_routing import routing_as
    from _tp_cases import compute_dtype
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models.transformer import loss_fn
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    spec = TP_FAMILIES[arch]
    reset_launches()
    out = {"transport": cwd.transport(dist.group.WORLD, device)}
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for name in spec["runs"]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        spans = Spans()
        tr = Trainer(TrainConfig(arch=arch, tp=world, layers=spec["layers"],
                                 compress_grads=name == "int8_ef", **TP_FAMILY_TRAIN),
                     device=device, spans=spans)
        mesh, group = tr.mesh, tr.mesh.group("model")
        rec = {"init_s": time.perf_counter() - t0,
               "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "state_memory_gb": torch.cuda.memory_allocated() / 1e9}
        pspecs = tr.specs["params"]
        whole = [not shd.is_split(sp, mesh) for sp in leaves(tr.specs)]
        if name == "exact":
            routing = (torch.load(f"{ref_dir}/routing.pt") if _is_moe(tr.cfg)
                       else None)
            with hints.set_mesh(mesh), compute_dtype(torch.float32), \
                    (routing_as(routing) if routing is not None
                     else contextlib.nullcontext([])) as flips:
                grads, m = make_grad_fn(tr.cfg, loss_chunks=TP_FAMILY_TRAIN["loss_chunks"])(
                    tr.state["params"], tr._device_batch(0))
            # this rank's block of each reference leaf, against its shard
            errs = []
            for i, (g, sp) in enumerate(zip(leaves(grads), leaves(pspecs))):
                want = shd.shard_tree(torch.load(f"{ref_dir}/{i}.pt"), sp, mesh).to(device)
                errs.append((float((g - want).abs().max()), float(want.abs().max())))
                del want
            rec["grad_check"] = {"leaves": len(errs), "err_and_scale": errs,
                                 "loss": float(m["loss"]),
                                 "routing_flips": int(sum(int(f.sum()) for f in flips)),
                                 "routed_tokens": int(sum(f.numel() for f in flips))}
            del grads
            torch.cuda.empty_cache()
            if routing is not None:
                # the first step's bf16 loss routed as TP = 1 chose in bf16
                with torch.no_grad(), hints.set_mesh(mesh), \
                        routing_as(torch.load(f"{ref_dir}/routing_bf16.pt")) as flips:
                    loss = loss_fn(tr.state["params"], tr.cfg, tr._device_batch(0),
                                   loss_chunks=TP_FAMILY_TRAIN["loss_chunks"])[0]
                rec["bf16_routed_as_tp1"] = {
                    "loss0": float(loss), "flips": int(sum(int(f.sum()) for f in flips)),
                    "routed_tokens": int(sum(f.numel() for f in flips))}
        torch.cuda.reset_peak_memory_stats()
        tokens = TP_FAMILY_TRAIN["global_batch"] * TP_FAMILY_TRAIN["seq_len"] // mesh.shape["data"]
        model = tpm.modeled_tp_bytes(tr.cfg, tokens, world)
        losses, walls, span_ms, tp_bytes, equal = [], [], [], [], []
        for i in range(TP_FAMILY_TRAIN["steps"]):
            tpm.tp_counter.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer_step(tr, i)["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            tp_bytes.append(dict(tpm.tp_counter.bytes))
            ms = spans.read()
            span_ms.append({k: round(sum(v), 3) if k == "tp_comm" else [round(x, 3) for x in v]
                            for k, v in ms.items()})
            span_ms[-1]["tp_comm_calls"] = len(ms.get("tp_comm", []))
            # every leaf no spec splits, across the TP ranks (outside the
            # counter): the router, w_dkv, in_BC, in_dt, conv_BC_*,
            # dt_bias, A_log, D, the norms, and their moments
            same = True
            for x, w in zip(leaves(tr.state), whole):
                if w:
                    host = x.detach().reshape(-1).cpu()
                    parts = [torch.empty_like(host) for _ in range(world)]
                    dist.all_gather(parts, host, group=group)
                    same &= all(torch.equal(parts[0], q) for q in parts[1:])
            equal.append(bool(same))
        rec.update({"losses": losses, "step_wall_s": walls,
                    "median_step_s": float(np.median(walls)), "spans_ms": span_ms[-1],
                    "tp_bytes_per_step": tp_bytes[-1], "modeled_tp_bytes_per_step": model,
                    "tp_bytes_equal_model": all(b == model for b in tp_bytes),
                    "whole_leaves_bit_equal": equal,
                    "step_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[name] = rec
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    out["launches"] = read_launches()
    return out


def tp_family_reference(arch: str, ref_dir: str) -> dict:
    """The TP = 1 reference of ``arch`` from the seed the ranks use: the
    first step's grads in f32 compute saved leaf by leaf in ``ref_dir``
    (with the routing a MoE chose, ``routing.pt``) and its loss; the
    losses of the stacked ``Trainer``'s runs where ``TP_FAMILIES`` asks
    for them, else the first step's loss in bf16. Frees the card before
    it returns."""
    import torch
    from _moe_routing import recorded_routing
    from _tp_cases import compute_dtype
    from repro_torch import configs as Cfg
    from repro_torch.data.pipeline import MarkovSource, make_device_placer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import transformer as Tm
    from repro_torch.parallel.sharding import BATCH_AXES
    from repro_torch.parallel.spec import P
    from repro_torch.tree import leaves

    spec, kw = TP_FAMILIES[arch], TP_FAMILY_TRAIN
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": {}}

    def save_grads(cfg, params, batch):
        with compute_dtype(torch.float32), recorded_routing() as seen:
            grads, m = make_grad_fn(cfg, loss_chunks=kw["loss_chunks"])(params, batch)
        for i, g in enumerate(leaves(grads)):
            torch.save(g.cpu(), f"{ref_dir}/{i}.pt")
        out["loss0"] = float(m["loss"])
        del grads
        # the first step's loss as the ranks' bf16 steps compute it, and
        # a MoE's routing there
        with torch.no_grad(), recorded_routing() as seen16:
            out["loss0_bf16"] = float(Tm.loss_fn(params, cfg, batch,
                                                 loss_chunks=kw["loss_chunks"])[0])
        if _is_moe(cfg):
            torch.save([t.cpu() for t in seen], f"{ref_dir}/routing.pt")
            torch.save([t.cpu() for t in seen16], f"{ref_dir}/routing_bf16.pt")

    if spec["reference"] == "grads":
        cfg = dataclasses.replace(Cfg.get_config(arch), num_layers=spec["layers"])
        gen = torch.Generator(device="cuda").manual_seed(kw["seed"])
        params = Tm.model_init(gen, cfg, "cuda")
        source = MarkovSource(vocab=cfg.vocab_size, seq_len=kw["seq_len"],
                              global_batch=kw["global_batch"], seed=kw["seed"] + 1)
        batch = make_device_placer(make_host_mesh(), P(BATCH_AXES, None), device="cuda")(
            source.batch(0))
        save_grads(cfg, params, batch)
        del params, batch
    else:
        for name in spec["runs"]:
            tr = Trainer(TrainConfig(arch=arch, layers=spec["layers"],
                                     compress_grads=name == "int8_ef", **kw), device="cuda")
            if name == "exact":
                save_grads(tr.cfg, tr.state["params"], tr._device_batch(0))
            out["losses"][name] = [float(trainer_step(tr, i)["loss"])
                                   for i in range(kw["steps"])]
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    return out


# qwen2-vl-7b (full width, 2 of 28 layers: M-RoPE on each rank's 14
# heads, qkv biases) and whisper-tiny (full size: its encoder,
# cross-attention and GeLU FFNs split by heads and columns, its 51,865-row
# table whole) through make_train_step at TP = 2, on batches the
# Trainer's token source cannot make: qwen2-vl's embeddings at
# image-then-text M-RoPE positions, whisper's tokens with encoder frames
TP_FAMILIES_FIXED = {"qwen2-vl-7b": 2, "whisper-tiny": None}
# their bf16 losses against TP = 1 over the steps: qwen2-vl's loss falls
# from 12.66 to 9.23 and 3.98 (the first AdamW steps, sign-like, move
# every weight by about the learning rate), so a rank's bf16 rounding of
# its partial sums moves the later losses more than yi-6b's (whose losses
# hardly move): 2.1-2.6e-3 measured on an H100, where the first-step f32
# grads agree to 5e-6 of each leaf's scale (the TP function is TP = 1's)
TP_FIXED_LOSS_TOL = 5e-3


def tp_fixed_family_config(arch: str, variant="baseline"):
    """``arch``'s config at ``TP_FAMILIES_FIXED``' depth with ``variant``'s
    overrides."""
    from repro_torch import configs as Cfg
    from repro_torch.launch.steps import VARIANTS

    cfg = Cfg.get_config(arch)
    return dataclasses.replace(cfg, num_layers=TP_FAMILIES_FIXED[arch] or cfg.num_layers,
                               **VARIANTS[variant])


def tp_fixed_family_setup(arch: str, device, mesh=None, spans=None, variant="baseline"):
    """``arch``'s config (at ``TP_FAMILIES_FIXED``' depth, with
    ``variant``'s overrides), its params from ``TP_FAMILY_TRAIN``'s seed
    (on a process ``mesh``, this rank's blocks as they are drawn), its
    batch (the same draws on every process) and a Torrent train step."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as Tm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd

    kw = TP_FAMILY_TRAIN
    cfg = tp_fixed_family_config(arch, variant)
    st = None if mesh is None else shd.train_state_specs(cfg, mesh)
    gen = torch.Generator(device=device).manual_seed(kw["seed"])
    params = Tm.model_init(gen, cfg, device, place=None if mesh is None
                           else shd.leaf_placer(st["params"], mesh))
    B, S = kw["global_batch"], kw["seq_len"]
    bgen = torch.Generator(device=device).manual_seed(kw["seed"] + 1)
    batch = {"labels": torch.randint(0, cfg.vocab_size, (B, S), generator=bgen, device=device,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["positions"] = vlm_positions(B, VLM_GRID, S - VLM_GRID[0] * VLM_GRID[1], device)
        batch["embeds"] = (torch.randn((B, S, cfg.d_model), generator=bgen, device=device)
                           * 0.02).to(torch.bfloat16)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S), generator=bgen,
                                        device=device, dtype=torch.int32)
        batch["enc_frames"] = audio_frames(bgen, B, cfg)
    opt_cfg = adamw.OptConfig(peak_lr=kw["peak_lr"], warmup_steps=kw["warmup_steps"],
                              decay_steps=kw["steps"] + 1)
    step = make_train_step(cfg, opt_cfg, collectives="torrent",
                           mesh=make_host_mesh() if mesh is None else mesh,
                           loss_chunks=kw["loss_chunks"], spans=spans)
    opt = adamw.init(params, specs=None if st is None else st["opt"],
                     mesh=make_host_mesh() if mesh is None else mesh)
    return cfg, params, opt, batch, step, st


def tp_fixed_family_reference(arch: str, ref_dir: str, variant="baseline",
                              device="cuda") -> dict:
    """The TP = 1 run of ``arch`` (:func:`tp_fixed_family_setup`): the
    first step's f32 grads saved leaf by leaf in ``ref_dir`` and its
    loss, the bf16 losses of ``TP_FAMILY_TRAIN``'s steps; frees the card
    before it returns."""
    import torch
    from _tp_cases import compute_dtype
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, opt, batch, step, _ = tp_fixed_family_setup(arch, device, variant=variant)
    with compute_dtype(torch.float32):
        grads, m = make_grad_fn(cfg, loss_chunks=TP_FAMILY_TRAIN["loss_chunks"])(params, batch)
    for i, g in enumerate(leaves(grads)):
        torch.save(g.cpu(), f"{ref_dir}/{i}.pt")
    out = {"layers": cfg.num_layers, "loss0": float(m["loss"])}
    del grads
    losses = []
    for _ in range(TP_FAMILY_TRAIN["steps"]):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    out.update(losses={"exact": losses}, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_fixed_family_rank(rank, world, device, arch, ref_dir, variant="baseline"):
    """One rank of the tp families phase for an arch of
    ``TP_FAMILIES_FIXED`` (with ``variant``'s overrides): its f32
    first-step grads against its block of the reference's leaves, then
    ``TP_FAMILY_TRAIN``'s bf16 Torrent steps on a ``(data=1,
    model=world)`` mesh with the records and checks of
    :func:`tp_family_rank`."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from _tp_cases import compute_dtype
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    mesh = make_process_mesh(model=world)
    group = mesh.group("model")
    reset_launches()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    out = {"transport": cwd.transport(dist.group.WORLD, device)}
    torch.cuda.reset_peak_memory_stats()
    spans = Spans()
    cfg, params, opt, batch, step, st = tp_fixed_family_setup(arch, device, mesh, spans,
                                                              variant)
    kw = TP_FAMILY_TRAIN
    batch_bytes = sum(x.nbytes for x in batch.values())
    rec = {"state_memory_gb": (torch.cuda.memory_allocated() - batch_bytes) / 1e9,
           "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    with hints.set_mesh(mesh), compute_dtype(torch.float32):
        grads, m = make_grad_fn(cfg, loss_chunks=kw["loss_chunks"])(params, batch)
    errs = []
    for i, (g, sp) in enumerate(zip(leaves(grads), leaves(st["params"]))):
        want = shd.shard_tree(torch.load(f"{ref_dir}/{i}.pt"), sp, mesh).to(device)
        errs.append((float((g - want).abs().max()), float(want.abs().max())))
        del want
    rec["grad_check"] = {"leaves": len(errs), "err_and_scale": errs, "loss": float(m["loss"]),
                         "routing_flips": 0, "routed_tokens": 0}
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S = kw["global_batch"], kw["seq_len"]
    model = tpm.modeled_tp_bytes(cfg, B * S, world, enc_tokens=B * cfg.encoder_seq_len)
    whole = [not shd.is_split(sp, mesh) for sp in leaves(st)]
    losses, walls, span_ms, tp_bytes, equal = [], [], [], [], []
    for _ in range(kw["steps"]):
        tpm.tp_counter.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        tp_bytes.append(dict(tpm.tp_counter.bytes))
        ms = spans.read()
        span_ms.append({k: round(sum(v), 3) if k == "tp_comm" else [round(x, 3) for x in v]
                        for k, v in ms.items()})
        span_ms[-1]["tp_comm_calls"] = len(ms.get("tp_comm", []))
        same = True
        for x, w in zip(leaves({"params": params, "opt": opt}), whole):
            if w:  # device tensors: NCCL takes no other, gloo stages them
                flat = x.detach().reshape(-1).contiguous()
                parts = [torch.empty_like(flat) for _ in range(world)]
                dist.all_gather(parts, flat, group=group)
                same &= all(torch.equal(parts[0], q) for q in parts[1:])
        equal.append(bool(same))
    rec.update({"losses": losses, "step_wall_s": walls, "median_step_s": float(np.median(walls)),
                "spans_ms": span_ms[-1], "tp_bytes_per_step": tp_bytes[-1],
                "modeled_tp_bytes_per_step": model,
                "tp_bytes_equal_model": all(b == model for b in tp_bytes),
                "whole_leaves_bit_equal": equal,
                "step_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    out["exact"] = rec
    out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    out["launches"] = read_launches()
    return out


def tp_families_phase(archs=None) -> dict:
    """Tensor parallelism for the MoE, MLA, Mamba-2, hybrid, vlm and
    audio families on the card (phase 19 of the module docstring), for
    ``archs`` of ``TP_FAMILIES`` and ``TP_FAMILIES_FIXED`` (default:
    all)."""
    import tempfile

    import numpy as np
    from repro_torch.launch.dist import spawn

    launches, failed = None, []
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    fixed = {arch: dict(layers=layers, runs=("exact",), reference="steps")
             for arch, layers in TP_FAMILIES_FIXED.items()}
    for arch, spec in {**TP_FAMILIES, **fixed}.items():
        if archs is not None and arch not in archs:
            continue
        ref_dir = tempfile.mkdtemp(prefix="tp_family_ref_")
        t0 = time.perf_counter()
        reference, rank_fn = ((tp_fixed_family_reference, tp_fixed_family_rank)
                              if arch in fixed else (tp_family_reference, tp_family_rank))
        try:
            ref = reference(arch, ref_dir)
            print(f"tp families {arch}: TP = 1 reference {json.dumps(ref)}", flush=True)
            # two jamba ranks hold ~36 GB each at the optimizer's peak: the
            # ranks' allocators map memory as they grow, so that what one
            # rank has reserved and not used cannot starve the other
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
            ranks = spawn(rank_fn, 2, backend="gloo", device="cuda", timeout_s=900,
                          args=(arch, ref_dir))
        finally:
            if alloc_conf is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
            shutil.rmtree(ref_dir, ignore_errors=True)
        wall = time.perf_counter() - t0
        for r, rec in enumerate(ranks):
            print(f"tp families {arch} rank {r}: {json.dumps(rec)}", flush=True)
        # the grads: per leaf, the worst rank's error over the leaf's max
        checks = [rk["exact"]["grad_check"] for rk in ranks]
        grad_err = max(max(c["err_and_scale"][i][0] for c in checks)
                       / max(max(c["err_and_scale"][i][1] for c in checks), 1e-30)
                       for i in range(checks[0]["leaves"]))
        loss0_err = abs(checks[0]["loss"] - ref["loss0"])
        loss_tol = (TP_MOE_LOSS_TOL if "bf16_routed_as_tp1" in ranks[0]["exact"]
                    else TP_FIXED_LOSS_TOL if arch in fixed else TP_LOSS_TOL)
        routed = ranks[0]["exact"].get("bf16_routed_as_tp1")
        if routed is not None:
            routed["loss0_diff"] = abs(routed["loss0"] - ref["loss0_bf16"])
            routed["unrouted_loss0_diff"] = abs(ranks[0]["exact"]["losses"][0] - ref["loss0_bf16"])
        errors = {}
        for name in spec["runs"]:
            got = ranks[0][name]["losses"]
            want = ref["losses"].get(name)
            errors[name] = (max(abs(a - b) for a, b in zip(got, want)) if want is not None
                            else abs(got[0] - ref["loss0_bf16"]))
            if not (all(rk[name]["losses"] == got for rk in ranks) and np.isfinite(got).all()
                    and errors[name] <= loss_tol
                    and all(rk[name]["tp_bytes_equal_model"] for rk in ranks)
                    and all(all(rk[name]["whole_leaves_bit_equal"]) for rk in ranks)
                    and all({"fwd_bwd", "reduce", "optimizer", "tp_comm"}
                            <= set(rk[name]["spans_ms"]) for rk in ranks)):
                failed.append(f"{arch} {name}")
                print(f"tp families {arch} {name}: FAILED losses {got} vs TP = 1 {want} "
                      f"(loss0 {ref['loss0']})", flush=True)
        arch_launches = {k: sum(rk["launches"][k] for rk in ranks) for k in ranks[0]["launches"]}
        if grad_err > TP_GRAD_F32_TOL or loss0_err > TP_GRAD_F32_TOL \
                or any(rk["alloc_retries"] for rk in ranks) or any(arch_launches.values()) \
                or {rk["transport"] for rk in ranks} != {"gloo via pinned host"}:
            failed.append(arch)
            print(f"tp families {arch}: FAILED f32 grad err {grad_err}, loss0 err "
                  f"{loss0_err} (tolerance {TP_GRAD_F32_TOL}), retries "
                  f"{[rk['alloc_retries'] for rk in ranks]}, launches {arch_launches}",
                  flush=True)
        launches = arch_launches if launches is None else {
            k: launches[k] + v for k, v in arch_launches.items()}
        print(f"tp families {arch}: {json.dumps({'ranks': 2, 'mesh': {'data': 1, 'model': 2}, 'layers': spec['layers'], 'reference': spec['reference'], 'first_step_f32_grad_max_rel_err': grad_err, 'first_step_f32_loss_diff': loss0_err, 'f32_tolerance': TP_GRAD_F32_TOL, 'routing_flips': [c['routing_flips'] for c in checks], 'routed_tokens': checks[0]['routed_tokens'], 'bf16_first_step_routed_as_tp1': routed, 'max_loss_diff_vs_tp1': errors, 'loss_tolerance': loss_tol, 'reference_peak_memory_gb': ref['peak_memory_gb'], 'state_memory_gb': [max(rk[n]['state_memory_gb'] for n in spec['runs']) for rk in ranks], 'step_peak_memory_gb': [max(rk[n]['step_peak_memory_gb'] for n in spec['runs']) for rk in ranks], 'median_step_s': {n: max(rk[n]['median_step_s'] for rk in ranks) for n in spec['runs']}, 'phase_wall_s': round(wall, 2), 'launches': arch_launches})}", flush=True)
    if failed:
        raise AssertionError(f"tp families: {failed} failed their checks (the lines above)")
    return {"train_launches": launches}


# tensor-parallel serving on the card: TP = 2 over two gloo ranks sharing
# it, full width, attn_impl="flash". Depths (None: every layer): mamba2-2.7b
# all 64 (11.3 GB of f32 params), jamba-v0.1-52b 5 of 32 (its attention
# layer and two MoE layers, ~27 GB); yi-6b (all 32 fit: 24.2 GB) and
# deepseek-v2-lite-16b (8 fit) cut to 8 and 4 layers, and qwen2-vl-7b to
# 4, so that the script stays within its time. The greedy tokens of a
# random model's depth decide which near ties the admission's first
# token (held equal to TP = 1's) meets: at 4 layers yi-6b's differs
# (an H100 run), so the depth stays 8
TP_SERVE = {"yi-6b": 8, "mamba2-2.7b": None, "deepseek-v2-lite-16b": 4,
            "jamba-v0.1-52b": 5, "qwen2-vl-7b": 4, "whisper-tiny": None}
# qwen2-vl's prompts are the vlm phase's (random embeddings at an image
# grid's M-RoPE positions, then text), whisper's the audio phase's
# (tokens with encoder frames); both decode at one position for every row
# (neither package decodes M-RoPE per slot, and write_cache_slot refuses
# whisper's enc leaf), so their traffic has no admission. whisper runs the
# plain attention: the flash wrapper refuses its 1500 encoder frames
TP_SERVE_FIXED = {"qwen2-vl-7b", "whisper-tiny"}
TP_SERVE_ATTN = {"whisper-tiny": "reference"}
# a flat-dispatch MoE served over data: (data=2, model=1), each rank's 2
# rows against one process's run of the whole batch, the ranks taking the
# global batch's capacity by exchanging their per-expert counts; 8 steps
# at one position, no admission
TP_SERVE_DP = {"deepseek-moe-16b": 4}
# the capacity rule's witness: the same prefill at this capacity factor,
# where a rank's own capacity (48 slots an expert for its 1,024 tokens)
# and the global batch's (96 for 2,048) keep many assignments differently:
# the ranks under the global rule must meet the whole batch's prefill,
# under the per-rank rule (the data axis Manual) they must not. The
# count of assignments the rules keep differently and the per-rank rule's
# prefill at the model's own 1.25 are printed beside it
TP_SERVE_DP_WITNESS_CF = 0.5
# the traffic: B prompts of S tokens prefilled at once, then STEPS greedy
# decode steps; before step ADMIT one (1, SLOT_LEN) prompt is prefilled
# into row SLOT, and the steps from there run at per-slot positions
TP_SERVE_TRAFFIC = dict(B=4, S=512, STEPS=32, ADMIT=16, SLOT=1, SLOT_LEN=256, seed=0)
TP_SERVE_MAX_SEQ = 576
# TP = 2 against TP = 1 in bf16, the bounds tests/test_torch_model.py
# holds these models to against JAX in bf16: logits within 5e-2 of the
# row's max |logit| (jamba's decode 8e-2), each cache leaf within 5e-2
# of its scale; a greedy token may differ only where the reference's
# top-2 margin is within the logit bound of the row's scale (a near tie)
TP_SERVE_LOGIT_TOL = 5e-2
TP_SERVE_DECODE_TOL = {"jamba-v0.1-52b": 8e-2}
TP_SERVE_CACHE_TOL = 5e-2
# models whose TP = 2 and TP = 1 runs are compared with both computing
# in f32 (``_tp_cases.compute_dtype``), and the prefill logit bound
# there: mamba2-2.7b's 64 SSD layers amplify the two TP sizes' bf16
# rounding differences to 0.358 of the logit scale at prefill (measured
# on an H100), as they amplify any bf16 difference (the ssm serve
# phase's drift bound is 0.25); in f32 the smoke model at 64 layers
# agrees to 1.9e-5 on the CPU, the full one to 1.1e-4 on the H100. Its
# decode still reads the bf16 conv window of the cache, so its decode
# logits keep the bf16 bound (2.6e-2 after 32 steps on the H100). It
# launches no kernel, so f32 costs the phase no kernel route
TP_SERVE_F32 = {"mamba2-2.7b"}
TP_SERVE_F32_LOGIT_TOL = 1e-3
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to the larger value


def tp_serve_config(arch: str, layers: int | None = -1, smoke: bool = False,
                    attn_impl: str = "flash"):
    """``arch``'s config at full width (``smoke``: its smoke config),
    with ``attn_impl``, cut to ``layers`` (None: every layer; by
    default its ``TP_SERVE`` depth)."""
    from repro_torch import configs as Cfg

    cfg = Cfg.get_smoke_config(arch) if smoke else Cfg.get_config(arch)
    layers = {**TP_SERVE, **TP_SERVE_DP}[arch] if layers == -1 else layers
    return dataclasses.replace(cfg, attn_impl=TP_SERVE_ATTN.get(arch, attn_impl),
                               num_layers=cfg.num_layers if layers is None else layers)


def tp_serve_prompts(cfg, t: dict, gen, device) -> dict:
    """The prefill batch of ``t``'s ``B`` prompts of ``S`` tokens from
    ``gen`` (a CPU generator): token ids; a vlm's bf16 embeddings at the
    vlm phase's image-then-text M-RoPE positions; an encoder-decoder's
    tokens with bf16 encoder frames. Then the rows ``t["rows"]``."""
    import torch

    B, S = t["B"], t["S"]
    if cfg.family == "vlm":  # the vlm phase's 16 x 16 grid, or a square half of S
        side = min(VLM_GRID[0], math.isqrt(S // 2))
        pos = vlm_positions(B, (side, side), S - side * side, "cpu")
        batch = {"embeds": (torch.randn((B, S, cfg.d_model), generator=gen) * 0.02).to(
            torch.bfloat16), "positions": pos}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                         dtype=torch.int32)}
        if cfg.is_encdec:
            batch["enc_frames"] = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                                              generator=gen).to(torch.bfloat16)
    rows = t.get("rows", slice(None))
    return {k: (v[:, rows] if k == "positions" else v[rows]).contiguous().to(device)
            for k, v in batch.items()}


def tp_serve_traffic(cfg, params, device, *, reference: dict | None = None,
                     traffic: dict | None = None, keep_prefill_cache: bool = False,
                     edit_cache=None) -> dict:
    """``traffic`` (default ``TP_SERVE_TRAFFIC``; its ``B`` rows are the
    caller's) through the step builders on ``params``: a
    ``make_prefill_step`` of the prompts (:func:`tp_serve_prompts`),
    ``make_serve_step`` steps (a ``make_slot_prefill_step`` admission
    written in with ``write_cache_slot`` before step ``ADMIT``, where it
    falls within the steps and the family decodes per slot: not a vlm
    or an encoder-decoder, which decode at one position), then one
    ``decode_step`` for the last logits in each MLA decode form. With
    ``reference`` (the TP = 1 run's record) each step is fed the tokens
    the reference was fed, so the two runs stay comparable where a near
    tie makes them pick differently; each step's own greedy tokens are
    recorded. Without it (the reference itself) each step runs
    ``decode_step`` and the same argmax, so that its top-2 margins are
    recorded too. ``tp_bytes`` holds the model group's payload of the
    prefill, of the first step and of the admission (``tp_counter``).
    ``keep_prefill_cache`` keeps a copy of the prefill's cache
    (``prefill_cache``); ``edit_cache(cache)`` replaces it before the
    first step. Returns the record; ``cache`` and the logits stay on the
    device."""
    import torch
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_slot_prefill_step, write_cache_slot)
    from repro_torch.models import transformer as Tm
    from repro_torch.parallel.tp import tp_counter
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import map_tree

    t = traffic or TP_SERVE_TRAFFIC
    S, SLOT = t["S"], t["SLOT"]
    gen = torch.Generator().manual_seed(t["seed"] + 1)
    batch = tp_serve_prompts(cfg, t, gen, device)
    B = batch["tokens"].shape[0] if "tokens" in batch else batch["embeds"].shape[0]
    slot = torch.randint(0, cfg.vocab_size, (1, t["SLOT_LEN"]), generator=gen,
                         dtype=torch.int32)
    # the per-slot admission, where the family decodes per slot
    admit = t["ADMIT"] if t["ADMIT"] < t["STEPS"] and cfg.family not in ("vlm", "audio") \
        else None
    step = make_serve_step(cfg)
    out = {"inputs": [], "tokens": [], "margins": [], "tp_bytes": {}}
    dev = torch.device(device)
    spans = Spans()  # CUDA events on a card

    def greedy(tok, pos, cache):
        if reference is not None:
            return step(params, tok, pos, cache)
        logits, cache = Tm.decode_step(params, cfg, tok, pos, cache)
        top2 = logits.topk(2, dim=-1).values
        out["margins"].append(((top2[:, 0] - top2[:, 1])
                               / logits.abs().amax(-1)).cpu())
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    with torch.no_grad():
        tp_counter.reset()
        with spans.span("prefill", dev):
            logits, cache = make_prefill_step(cfg, TP_SERVE_MAX_SEQ)(params, batch)
        out["tp_bytes"]["prefill"] = dict(tp_counter.bytes)
        out["prefill_logits"] = logits
        if keep_prefill_cache:
            out["prefill_cache"] = map_tree(torch.clone, cache)
        if edit_cache is not None:
            cache = edit_cache(cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        pos = torch.full((B,), S, dtype=torch.int32, device=device)
        out["slot_token"] = None
        for i in range(t["STEPS"]):
            if i == admit:
                tp_counter.reset()
                first, one = make_slot_prefill_step(cfg, TP_SERVE_MAX_SEQ)(params,
                                                                            slot.to(device))
                out["tp_bytes"]["slot"] = dict(tp_counter.bytes)
                write_cache_slot(cache, one, SLOT)
                out["slot_token"] = int(first[0])
                tok[SLOT] = first[0]
                pos[SLOT] = t["SLOT_LEN"]
            if reference is not None:
                tok = reference["inputs"][i].to(device)
            out["inputs"].append(tok.cpu())
            p = pos if admit is not None and i >= admit else torch.tensor(S + i,
                                                                          dtype=torch.int32)
            tp_counter.reset()
            with spans.span("step", dev):
                tok, cache = greedy(tok, p, cache)
            out["tp_bytes"].setdefault("decode", dict(tp_counter.bytes))
            out["tokens"].append(tok.cpu())
            pos += 1
        if reference is not None:
            tok = reference["last_input"].to(device)
        out["last_input"] = tok.cpu()
        out["final_logits"] = {}
        forms = (False, True) if cfg.attention == "mla" else (cfg.mla_absorb,)
        for absorb in forms:
            c = dataclasses.replace(cfg, mla_absorb=absorb)
            snapshot = map_tree(torch.clone, cache) if len(forms) > 1 else cache
            p = pos if admit is not None else torch.tensor(S + t["STEPS"], dtype=torch.int32)
            out["final_logits"][absorb] = Tm.decode_step(params, c, tok, p, snapshot)[0]
        out["cache"] = cache
    ms = spans.read()
    out["prefill_ms"], out["step_ms"] = ms["prefill"][0], ms["step"]
    return out


def tp_serve_reference(arch: str, ref_dir: str, device="cuda", layers: int | None = -1,
                       traffic: dict | None = None, smoke: bool = False,
                       witness_cf: float | None = None) -> dict:
    """The TP = 1 run of ``arch`` (cut to ``layers``, as
    :func:`tp_serve_config`, with the plain attention: the ranks' flash
    kernel is held against it) on the card from the seed the ranks use
    (``tp_serve_traffic`` of ``traffic``), its MoE calls' routing
    recorded: logits, tokens, margins, routing and the cache saved in
    ``ref_dir``, and for ``TP_SERVE_F32`` its prefill's cache too; with
    ``witness_cf`` also the prefill's logits and routing at that capacity
    factor (``{arch}_witness.pt``); frees the card before it returns.
    Returns its times and peak memory."""
    import numpy as np
    import torch
    from _moe_routing import recorded_routing
    from repro_torch.models import transformer as Tm
    from repro_torch.tree import leaves

    cuda = torch.device(device).type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = tp_serve_config(arch, layers, smoke, attn_impl="reference")
    params = Tm.model_init(torch.Generator(device=device).manual_seed(TP_SERVE_TRAFFIC["seed"]),
                           cfg, device)
    reset_launches()
    with recorded_routing() as seen, _serve_dtype(arch):
        rec = tp_serve_traffic(cfg, params, device, traffic=traffic,
                               keep_prefill_cache=arch in TP_SERVE_F32)
    if arch in TP_SERVE_F32:
        torch.save([x.cpu() for x in leaves(rec.pop("prefill_cache"))],
                   f"{ref_dir}/{arch}_prefill_cache.pt")
    torch.save({"prefill_logits": rec["prefill_logits"].cpu(),
                "final_logits": {k: v.cpu() for k, v in rec["final_logits"].items()},
                "inputs": rec["inputs"], "tokens": rec["tokens"], "margins": rec["margins"],
                "last_input": rec["last_input"], "slot_token": rec["slot_token"],
                "routing": [x.cpu() for x in seen]}, f"{ref_dir}/{arch}.pt")
    torch.save([x.cpu() for x in leaves(rec["cache"])], f"{ref_dir}/{arch}_cache.pt")
    if witness_cf is not None:
        from repro_torch.launch.steps import make_prefill_step

        wcfg = dataclasses.replace(cfg, capacity_factor=witness_cf)
        t = traffic or TP_SERVE_TRAFFIC
        batch = tp_serve_prompts(wcfg, t, torch.Generator().manual_seed(t["seed"] + 1), device)
        with torch.no_grad(), recorded_routing() as wseen, _serve_dtype(arch):
            wlogits, _ = make_prefill_step(wcfg, TP_SERVE_MAX_SEQ)(params, batch)
        torch.save({"prefill_logits": wlogits.cpu(), "routing": [x.cpu() for x in wseen]},
                   f"{ref_dir}/{arch}_witness.pt")
        del batch, wlogits
    out = {"layers": cfg.num_layers, "prefill_ms": rec["prefill_ms"],
           "decode_step_ms": float(np.median(rec["step_ms"])),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
           "launches": read_launches(), "moe_calls": len(seen)}
    del params, rec, seen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _serve_dtype(arch: str):
    """The compute dtype of ``arch``'s tp serve runs: f32 for
    ``TP_SERVE_F32``, else the default (bf16)."""
    import torch
    from _tp_cases import compute_dtype

    return compute_dtype(torch.float32) if arch in TP_SERVE_F32 else contextlib.nullcontext()


def token_differences(tokens: list, ref: dict) -> list[dict]:
    """Every (step, row) whose greedy token in ``tokens`` differs from
    the reference's, with the reference's top-2 margin there relative to
    its row's max |logit|. Each step is fed the reference's tokens, so
    each difference is a choice of its own."""
    return [{"step": i, "row": r, "reference_top2_margin_rel": float(ref["margins"][i][r])}
            for i, (a, b) in enumerate(zip(tokens, ref["tokens"]))
            for r in (a != b).nonzero().flatten().tolist()]


def _rel_rows(a, b) -> float:
    """The worst row's max |a - b| over that row's max |b|."""
    return float(((a.float() - b.float()).abs().amax(-1) / b.float().abs().amax(-1)).max())


def tp_serve_rank(rank, world, device, ref_dir, archs):
    """One rank of the tp serve phase (a spawned process): for each arch
    of ``TP_SERVE``, this rank's shards (``param_pspecs`` placed as each
    leaf is drawn, the same seed) serve ``TP_SERVE_TRAFFIC`` on a
    ``(data=1, model=world)`` mesh, fed the reference's tokens and routed
    as it routed (``tests/_moe_routing.py``); the record holds the
    greedy tokens against the reference's, the gathered logits and
    cache against its, the model group's payload of the prefill, a
    decode step and the admission against ``modeled_tp_serve_bytes``,
    the times, the ``tp_comm`` spans, the peak memory, allocator retries
    and this rank's flash launches. The gathered logits go back to the
    phase, which holds the two ranks' bit for bit."""
    import numpy as np
    import torch
    from _moe_routing import routing_as
    from repro_torch import configs as Cfg
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import transformer as Tm
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    mesh = make_process_mesh(model=world)
    t = TP_SERVE_TRAFFIC
    out = {}
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for arch in archs:
        cfg = tp_serve_config(arch)
        ref = torch.load(f"{ref_dir}/{arch}.pt", weights_only=False)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        specs = shd.logical_pspecs(cfg, world)
        params = Tm.model_init(torch.Generator(device=device).manual_seed(t["seed"]), cfg,
                               device, place=shd.leaf_placer(specs, mesh))
        rec = {"init_s": time.perf_counter() - t0,
               "state_memory_gb": torch.cuda.memory_allocated() / 1e9,
               "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        spans = Spans()
        t1 = time.perf_counter()
        with hints.set_mesh(mesh), tpm.timed(spans), routing_as(ref["routing"]) as flips, \
                _serve_dtype(arch):
            got = tp_serve_traffic(cfg, params, device, reference=ref,
                                   keep_prefill_cache=arch in TP_SERVE_F32)
            sizes = {"prefill": (t["B"], t["S"]), "decode": (t["B"], 1),
                     "slot": (1, t["SLOT_LEN"])}
            model = {k: tpm.modeled_tp_serve_bytes(cfg, *sizes[k], world)
                     for k in got["tp_bytes"]}
        wall = time.perf_counter() - t1
        comm = spans.read().get("tp_comm", [])
        cspecs = shd.logical_cache_pspecs(cfg, Cfg.SHAPES["decode_32k"], t["B"],
                                          TP_SERVE_MAX_SEQ, world)
        if "prefill_cache" in got:  # for the witness, in JAX's layout
            kept = shd.gather_cache(got.pop("prefill_cache"), cspecs, cfg, mesh)
            if rank == 0:
                torch.save([x.cpu() for x in leaves(kept)], f"{ref_dir}/{arch}_tp_prefill_cache.pt")
            del kept
        cache = shd.gather_cache(got["cache"], cspecs, cfg, mesh)
        want_cache = torch.load(f"{ref_dir}/{arch}_cache.pt", weights_only=False)
        cache_err = [float((a.float() - b.to(device).float()).abs().max()
                           / b.float().abs().max().clamp_min(1e-30))
                     for a, b in zip(leaves(cache), want_cache)]
        del cache, want_cache
        diffs = token_differences(got["tokens"], ref)
        rec.update({
            "layers": cfg.num_layers,
            "tokens_equal": not diffs,
            "differences": diffs,
            "first_difference": diffs[0] if diffs else None,
            "max_difference_margin_rel": max((d["reference_top2_margin_rel"] for d in diffs),
                                             default=None),
            "slot_token_equal": got["slot_token"] == ref["slot_token"],
            "prefill_logits_rel": _rel_rows(got["prefill_logits"].cpu(), ref["prefill_logits"]),
            "final_logits_rel": {str(k): _rel_rows(v.cpu(), ref["final_logits"][k])
                                 for k, v in got["final_logits"].items()},
            "cache_rel_max": max(cache_err),
            "tp_bytes": got["tp_bytes"], "modeled_tp_bytes": model,
            "tp_bytes_equal_model": got["tp_bytes"] == model,
            "prefill_ms": got["prefill_ms"],
            "decode_step_ms": float(np.median(got["step_ms"])),
            "traffic_wall_s": wall,
            "tp_comm_ms": sum(comm), "tp_comm_calls": len(comm),
            "tp_comm_share": sum(comm) / 1e3 / wall,
            "routing_flips": int(sum(int(f.sum()) for f in flips)),
            "routed_tokens": int(sum(f.numel() for f in flips)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": read_launches(),
            "logits": {"prefill": got["prefill_logits"].cpu(),
                       **{f"final_{k}": v.cpu() for k, v in got["final_logits"].items()}}})
        out[arch] = rec
        del params, got
    out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    return out


def tp_serve_witness(arch: str, ref_dir: str, device="cuda") -> dict:
    """Where the TP ranks' decode logits part from the TP = 1 reference's
    for an arch of ``TP_SERVE_F32`` (f32 compute, a bf16 ``conv`` window
    in the cache). The ranks' gathered prefill cache against TP = 1's:
    each bf16 leaf element by element within one bf16 rounding step of
    the larger value plus ``TP_SERVE_F32_LOGIT_TOL`` of the leaf's scale
    (``cache_within_one_bf16_step``), each f32 leaf's max relative
    difference. Then TP = 1's own traffic (fed the reference's tokens)
    replayed from three prefill caches, each one's last logits against
    the reference's: its own (the replay's noise floor), the ranks'
    (``tp1_from_tp_cache_rel``: what their rounding alone does), and its
    own with the two ranks' head blocks swapped in the SSM state and the
    ``x`` part of the window (what a wrong head split would do). Runs in
    this process on ``device`` after the ranks have freed the card."""
    import torch
    from repro_torch.models import transformer as Tm
    from repro_torch.tree import leaves, paths, unflatten

    cfg = tp_serve_config(arch, attn_impl="reference")
    ref = torch.load(f"{ref_dir}/{arch}.pt", weights_only=False)
    own = torch.load(f"{ref_dir}/{arch}_prefill_cache.pt", weights_only=False)
    tp = torch.load(f"{ref_dir}/{arch}_tp_prefill_cache.pt", weights_only=False)
    keys = [p[-1] for p, _ in paths(Tm.init_cache(cfg, 1, 1, device="meta"))]
    out = {"cache": {}, "cache_within_one_bf16_step": True}
    for i, (key, a, b) in enumerate(zip(keys, tp, own)):
        diff = (a.float() - b.float()).abs()
        scale = b.float().abs().max().clamp_min(1e-30)
        if b.dtype == torch.bfloat16:
            bound = BF16_STEP * torch.maximum(a.float().abs(), b.float().abs())
            worst = float((diff / (bound + TP_SERVE_F32_LOGIT_TOL * scale)).max())
            out["cache_within_one_bf16_step"] &= worst <= 1
            out["cache"][f"{i}/{key}"] = {"max_of_bound": worst,
                                          "share_differing": float((diff > 0).float().mean())}
        else:
            out["cache"][f"{i}/{key}"] = {"max_rel": float(diff.max() / scale)}

    def swapped(key, x):
        if key == "ssm":  # (reps, B, H, ...): the two ranks' heads exchanged
            return torch.roll(x, x.shape[2] // 2, dims=2)
        if key == "conv":  # [x, B, C]: the two ranks' x blocks exchanged
            d = cfg.d_inner
            return torch.cat([torch.roll(x[..., :d], d // 2, dims=-1), x[..., d:]], -1)
        return x

    params = Tm.model_init(torch.Generator(device=device).manual_seed(TP_SERVE_TRAFFIC["seed"]),
                           cfg, device)
    last = next(iter(ref["final_logits"]))

    def replay(start: list) -> float:
        def edit(cache):
            return unflatten(cache, [x.to(device=device, dtype=c.dtype)
                                     for x, c in zip(start, leaves(cache))])

        with _serve_dtype(arch):
            rec = tp_serve_traffic(cfg, params, device, reference=ref, edit_cache=edit)
        return _rel_rows(rec["final_logits"][last].cpu(), ref["final_logits"][last])

    out["tp1_from_own_cache_rel"] = replay(own)
    out["tp1_from_tp_cache_rel"] = replay(tp)
    out["tp1_from_swapped_heads_rel"] = replay([swapped(k, x) for k, x in zip(keys, own)])
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


TP_SERVE_DP_TRAFFIC = dict(TP_SERVE_TRAFFIC, STEPS=8, ADMIT=8)


def capacity_rule_differences(routing: list, cfg, world: int) -> int:
    """How many of the expert assignments in ``routing`` (one top-k
    tensor per prefill MoE call, the whole batch's tokens in order, rank
    0's block first) a rank's own capacity keeps and the global batch's
    drops, or the reverse: an assignment's position among its expert's
    assignments counted within its rank's block against
    ``capacity(cfg, T)``, and counted over the whole stream against
    ``capacity(cfg, T · world)``."""
    import torch
    from repro_torch.models.moe import capacity

    total = 0
    for top_e in routing:
        flat = top_e.reshape(-1).long()
        n, t = flat.numel(), top_e.shape[0] // world
        onehot = torch.nn.functional.one_hot(flat, cfg.num_experts)
        at = flat[:, None]
        pos_global = (onehot.cumsum(0) - 1).gather(1, at)[:, 0]
        pos_rank = (onehot.reshape(world, n // world, -1).cumsum(1) - 1).reshape(n, -1).gather(
            1, at)[:, 0]
        total += int(((pos_rank < capacity(cfg, t))
                      != (pos_global < capacity(cfg, t * world))).sum())
    return total


def tp_serve_dp_rank(rank, world, device, ref_dir, arch):
    """One rank of the tp serve phase's MoE over data (``TP_SERVE_DP``):
    its rows of ``TP_SERVE_DP_TRAFFIC`` on a ``(data=world, model=1)``
    mesh, fed the reference's tokens and routed as the reference routed
    its rows: prefill and final logits, tokens, its cache against the
    reference's rows, and the payload the ranks exchange (the per-expert
    counts) against ``modeled_tp_serve_bytes(dp=world)``. Then the
    capacity rule's witness (``TP_SERVE_DP_WITNESS_CF``): the prefill at
    that capacity factor and at the model's, routed as the reference's,
    under the global rule and under the per-rank rule
    (``hints.manual_axes``), each against the reference's rows and timed
    on the host's clock around a synchronize (the global rule's expert
    buffer holds up to ``world`` times the per-rank rule's slots), and
    the assignments the two rules keep differently
    (:func:`capacity_rule_differences`)."""
    import numpy as np
    import torch
    from _moe_routing import routing_as
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import transformer as Tm
    from repro_torch.parallel import hints
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    mesh = make_process_mesh(data=world)
    t = dict(TP_SERVE_DP_TRAFFIC)
    n = t["B"] // world
    rows = slice(rank * n, (rank + 1) * n)
    t["rows"] = rows
    cfg = tp_serve_config(arch)
    full = torch.load(f"{ref_dir}/{arch}.pt", weights_only=False)

    def mine(x):  # this rank's block of a whole-batch tensor (token-major)
        k = x.shape[0] // world
        return x[rank * k:(rank + 1) * k]

    ref = {**full, "inputs": [x[rows] for x in full["inputs"]],
           "tokens": [x[rows] for x in full["tokens"]],
           "margins": [x[rows] for x in full["margins"]], "last_input": full["last_input"][rows],
           "routing": [mine(x) for x in full["routing"]]}
    torch.cuda.reset_peak_memory_stats()
    params = Tm.model_init(torch.Generator(device=device).manual_seed(t["seed"]), cfg, device)
    reset_launches()
    spans = Spans()
    with hints.set_mesh(mesh), tpm.timed(spans), routing_as(ref["routing"]) as flips:
        got = tp_serve_traffic(cfg, params, device, reference=ref, traffic=t)
        model = {"prefill": tpm.modeled_tp_serve_bytes(cfg, n, t["S"], 1, dp=world),
                 "decode": tpm.modeled_tp_serve_bytes(cfg, n, 1, 1, dp=world)}
    launches = read_launches()  # the main path's; the witness's prefills are not counted
    from repro_torch.launch.steps import make_prefill_step

    wref = torch.load(f"{ref_dir}/{arch}_witness.pt", weights_only=False)
    wcfg = dataclasses.replace(cfg, capacity_factor=TP_SERVE_DP_WITNESS_CF)
    prompt_tokens = t["B"] * t["S"]
    routing = [x for x in full["routing"] if x.shape[0] == prompt_tokens]  # the prefill's
    batch = tp_serve_prompts(cfg, t, torch.Generator().manual_seed(t["seed"] + 1), device)
    witness = {"capacity_factor": TP_SERVE_DP_WITNESS_CF}
    main = {"routing": routing, "prefill_logits": full["prefill_logits"]}
    runs = (("global_rule", wcfg, (), wref), ("per_rank_rule", wcfg, ("data",), wref),
            ("global_rule_at_model_cf", cfg, (), main),
            ("per_rank_rule_at_model_cf", cfg, ("data",), main))
    with torch.no_grad(), hints.set_mesh(mesh):
        for name, c, manual, want in runs:
            with hints.manual_axes(manual), routing_as([mine(x) for x in want["routing"]]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = make_prefill_step(c, TP_SERVE_MAX_SEQ)(params, batch)
                torch.cuda.synchronize()
            witness[f"{name}_prefill_ms"] = (time.perf_counter() - t0) * 1e3
            witness[f"{name}_prefill_logits_rel"] = _rel_rows(
                lg.cpu(), want["prefill_logits"][rows])
    witness["assignments_kept_differently"] = capacity_rule_differences(
        wref["routing"], wcfg, world)
    witness["assignments_kept_differently_at_model_cf"] = capacity_rule_differences(
        routing, cfg, world)
    witness["prefill_assignments"] = sum(x.numel() for x in routing)
    del batch, lg
    want_cache = torch.load(f"{ref_dir}/{arch}_cache.pt", weights_only=False)
    cache_err = [float((a.float() - b[:, rows].to(device).float()).abs().max()
                       / b[:, rows].float().abs().max().clamp_min(1e-30))
                 for a, b in zip(leaves(got["cache"]), want_cache)]
    diffs = token_differences(got["tokens"], ref)
    comm = spans.read().get("tp_comm", [])
    return {"rows": [rows.start, rows.stop], "layers": cfg.num_layers,
            "differences": diffs,
            "prefill_logits_rel": _rel_rows(got["prefill_logits"].cpu(),
                                            full["prefill_logits"][rows]),
            "final_logits_rel": {str(k): _rel_rows(v.cpu(), full["final_logits"][k][rows])
                                 for k, v in got["final_logits"].items()},
            "cache_rel_max": max(cache_err),
            "exchange_bytes": got["tp_bytes"], "modeled_exchange_bytes": model,
            "exchange_bytes_equal_model": got["tp_bytes"] == model,
            "exchange_calls": len(comm), "exchange_ms": sum(comm),
            "prefill_ms": got["prefill_ms"], "decode_step_ms": float(np.median(got["step_ms"])),
            "routing_flips": int(sum(int(f.sum()) for f in flips)),
            "routed_tokens": int(sum(f.numel() for f in flips)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0),
            "capacity_witness": witness, "launches": launches}


def tp_serve_phase(archs=tuple(TP_SERVE), dp_archs=tuple(TP_SERVE_DP)) -> dict:
    """Tensor-parallel serving on the card (phase 20 of the module
    docstring), for ``archs`` of ``TP_SERVE``, then the MoE over data
    for ``dp_archs`` of ``TP_SERVE_DP``."""
    import tempfile

    import torch
    from repro_torch.launch.dist import spawn

    ref_dir = tempfile.mkdtemp(prefix="tp_serve_ref_")
    t0 = time.perf_counter()
    try:
        refs = {}
        for arch in archs:
            refs[arch] = tp_serve_reference(arch, ref_dir)
            print(f"tp serve {arch}: TP = 1 reference {json.dumps(refs[arch])}", flush=True)
        ranks = spawn(tp_serve_rank, 2, backend="gloo", device="cuda", timeout_s=900,
                      args=(ref_dir, archs)) if archs else []
        witness = {arch: tp_serve_witness(arch, ref_dir) for arch in archs
                   if arch in TP_SERVE_F32}
        dp_ranks = {}
        for arch in dp_archs:
            refs[arch] = tp_serve_reference(arch, ref_dir, traffic=TP_SERVE_DP_TRAFFIC,
                                            witness_cf=TP_SERVE_DP_WITNESS_CF)
            print(f"tp serve {arch} over data: TP = 1 reference {json.dumps(refs[arch])}",
                  flush=True)
            dp_ranks[arch] = spawn(tp_serve_dp_rank, 2, backend="gloo", device="cuda",
                                   timeout_s=900, args=(ref_dir, arch))
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches, failed = None, []
    for arch in archs:
        recs = [rk[arch] for rk in ranks]
        logits = [r.pop("logits") for r in recs]
        same = all(torch.equal(logits[0][k], lg[k]) for lg in logits[1:] for k in logits[0])
        for r, rec in enumerate(recs):
            print(f"tp serve {arch} rank {r}: {json.dumps(rec)}", flush=True)
        prefill_tol = TP_SERVE_F32_LOGIT_TOL if arch in TP_SERVE_F32 else TP_SERVE_LOGIT_TOL
        decode_tol = TP_SERVE_DECODE_TOL.get(arch, TP_SERVE_LOGIT_TOL)
        rec = recs[0]
        near_tie = all(d["reference_top2_margin_rel"] <= decode_tol for r in recs
                       for d in r["differences"])
        arch_launches = {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}
        flash = [r["launches"]["flash_attention_wgmma"] for r in recs]
        cfg = tp_serve_config(arch)
        prefills = 1 + ("slot" in rec["tp_bytes"])  # the prompts', the admission's
        want_flash = (cfg.attn_impl == "flash") * prefills * sum(
            s.mixer == "gqa" for p, reps in cfg.layer_groups() for s in p for _ in range(reps))
        ok = (same and near_tie and all(r["slot_token_equal"] for r in recs)
              and all(r["prefill_logits_rel"] <= prefill_tol for r in recs)
              and all(v <= decode_tol for r in recs for v in r["final_logits_rel"].values())
              and all(r["cache_rel_max"] <= TP_SERVE_CACHE_TOL for r in recs)
              and all(r["tp_bytes_equal_model"] for r in recs)
              and all(f == want_flash for f in flash)
              and not any(rk["alloc_retries"] for rk in ranks))
        if arch in witness:  # the decode gap is the prefill cache's rounding
            w = witness[arch]
            w["tp_decode_logits_rel"] = max(v for r in recs
                                            for v in r["final_logits_rel"].values())
            w["ratio"] = w["tp1_from_tp_cache_rel"] / w["tp_decode_logits_rel"]
            ok = ok and w["cache_within_one_bf16_step"] and 0.25 <= w["ratio"] <= 4
            print(f"tp serve {arch} witness: {json.dumps(w)}", flush=True)
        summary = {"ranks": 2, "mesh": {"data": 1, "model": 2}, "layers": rec["layers"],
                   "tokens_equal": rec["tokens_equal"], "first_difference": rec["first_difference"],
                   "differences": len(rec["differences"]),
                   "max_difference_margin_rel": rec["max_difference_margin_rel"],
                   "ranks_logits_bit_equal": same,
                   "prefill_logits_rel": [r["prefill_logits_rel"] for r in recs],
                   "final_logits_rel": [r["final_logits_rel"] for r in recs],
                   "compute_dtype": "float32" if arch in TP_SERVE_F32 else "bfloat16",
                   "logit_tolerance": [prefill_tol, decode_tol],
                   "cache_rel_max": [r["cache_rel_max"] for r in recs],
                   "cache_tolerance": TP_SERVE_CACHE_TOL,
                   "tp_bytes_equal_model": [r["tp_bytes_equal_model"] for r in recs],
                   "tp_comm_share": [r["tp_comm_share"] for r in recs],
                   "prefill_ms": [r["prefill_ms"] for r in recs],
                   "decode_step_ms": [r["decode_step_ms"] for r in recs],
                   "reference": refs[arch],
                   "state_memory_gb": [r["state_memory_gb"] for r in recs],
                   "peak_memory_gb": [r["peak_memory_gb"] for r in recs],
                   "routing_flips": [r["routing_flips"] for r in recs],
                   "flash_launches_per_rank": flash, "flash_launches_expected": want_flash,
                   "alloc_retries": [rk["alloc_retries"] for rk in ranks]}
        print(f"tp serve {arch}: {json.dumps(summary)}", flush=True)
        if not ok:
            failed.append(arch)
        launches = arch_launches if launches is None else {
            k: launches[k] + v for k, v in arch_launches.items()}
    for arch, recs in dp_ranks.items():
        for r, rec in enumerate(recs):
            print(f"tp serve {arch} over data rank {r}: {json.dumps(rec)}", flush=True)
        ok = (all(d["reference_top2_margin_rel"] <= TP_SERVE_LOGIT_TOL for r in recs
                  for d in r["differences"])
              and all(r["prefill_logits_rel"] <= TP_SERVE_LOGIT_TOL for r in recs)
              and all(v <= TP_SERVE_LOGIT_TOL for r in recs for v in r["final_logits_rel"].values())
              and all(r["cache_rel_max"] <= TP_SERVE_CACHE_TOL for r in recs)
              and all(r["exchange_bytes_equal_model"] for r in recs)
              and all(r["launches"]["flash_attention_wgmma"] == r["layers"] for r in recs)
              and not any(r["alloc_retries"] for r in recs)
              and all(w["global_rule_prefill_logits_rel"] <= TP_SERVE_LOGIT_TOL
                      and w["per_rank_rule_prefill_logits_rel"] > TP_SERVE_LOGIT_TOL
                      and w["assignments_kept_differently"] > 0
                      for w in (r["capacity_witness"] for r in recs)))
        summary = {"ranks": 2, "mesh": {"data": 2, "model": 1}, "layers": recs[0]["layers"],
                   "differences": [len(r["differences"]) for r in recs],
                   "prefill_logits_rel": [r["prefill_logits_rel"] for r in recs],
                   "final_logits_rel": [r["final_logits_rel"] for r in recs],
                   "logit_tolerance": TP_SERVE_LOGIT_TOL,
                   "cache_rel_max": [r["cache_rel_max"] for r in recs],
                   "exchange_bytes": recs[0]["exchange_bytes"],
                   "modeled_exchange_bytes": recs[0]["modeled_exchange_bytes"],
                   "exchange_bytes_equal_model": [r["exchange_bytes_equal_model"] for r in recs],
                   "routing_flips": [r["routing_flips"] for r in recs],
                   "prefill_ms": [r["prefill_ms"] for r in recs],
                   "decode_step_ms": [r["decode_step_ms"] for r in recs],
                   "reference": refs[arch],
                   "capacity_witness": [r["capacity_witness"] for r in recs],
                   "peak_memory_gb": [r["peak_memory_gb"] for r in recs]}
        print(f"tp serve {arch} over data: {json.dumps(summary)}", flush=True)
        if not ok:
            failed.append(f"{arch} over data")
        launches = {k: (launches or {}).get(k, 0) + sum(r["launches"][k] for r in recs)
                    for k in recs[0]["launches"]}
    print(f"tp serve: {json.dumps({'phase_wall_s': round(wall, 2), 'launches': launches})}",
          flush=True)
    if failed:
        raise AssertionError(f"tp serve: {failed} failed their checks (the lines above)")
    return {"serve_launches": launches}


# ---------------------------------------------------------------------------
# Long context: long_500k on a ProcessMesh, a sequence-parallel decode
# ---------------------------------------------------------------------------

# build_cell's long_500k cell on (data=2, model=1), two gloo ranks sharing
# the card: h2o-danube-1.8b at full width and depth (its 4096-slot window:
# 2048 slots a rank), mamba2-2.7b at full width, 4 of 64 layers (no slot
# axis: every rank decodes alike)
LONG = {"h2o-danube-1.8b": None, "mamba2-2.7b": 4}
# the positions decoded, each from the seeded whole cache: 0 (only slot 0,
# on rank 0, is valid), one whose slot is rank 1's, and two past the
# window's wraps (slots in rank 0's and rank 1's blocks), the last the
# shape's last position
LONG_POSITIONS = (0, 3071, 410600, 524287)
LONG_TIMED_STEPS = 8
LONG_SEED = 7
# the same decodes with both sides computing in f32 (``_tp_cases.
# compute_dtype``): in bf16 the slot blocks' sums in another order round
# the attention output to a neighbouring bf16 value now and then, which
# 24 random layers amplify (h2o-danube-1.8b: 1.9-3.2e-2 of the row's max
# on an H100, within TP_SERVE_LOGIT_TOL). In f32 compute the activations
# keep f32, but the normalised weights are still rounded to the bf16
# cache's dtype before the values' products (as on the whole cache), so
# a weight the two sum orders put on either side of a bf16 rounding
# boundary still moves: 1.8-4.5e-4 of the row's max on an H100 over
# h2o-danube's 24 layers and 4096 slots (jamba's one attention layer on
# four cards 1.8e-6-2.7e-5; 5e-7 at smoke size on the CPU,
# tests/test_torch_tp_serve.py). A wrong slot, mask or merge moves the
# logits by O(1e-1)
LONG_F32_TOL = 1e-3


@contextlib.contextmanager
def cut_depth(arch: str, layers: int | None):
    """``configs.get_config(arch)`` (what ``build_cell`` reads) cut to its
    first ``layers`` layers inside the block (``None``: whole)."""
    from repro_torch import configs as Cfg

    if layers is None:
        yield
        return
    get = Cfg.get_config

    def cut(name):
        cfg = get(name)
        return dataclasses.replace(cfg, num_layers=layers) if name == arch else cfg

    Cfg.get_config = cut
    try:
        yield
    finally:
        Cfg.get_config = get


def long_rank(rank, world, device, arch, layers, shape_name="long_500k", smoke=False,
              model=1):
    """One rank of the long phase: ``build_cell(arch, shape_name,
    (data=world/model, model))``, its cache block filled from a seeded
    whole cache (the same draw in every process, ``place_cache``), its
    step run at each of ``LONG_POSITIONS`` (those within the shape)
    against ``decode_step`` on the whole cache with no mesh (the data = 1,
    TP = 1 decode, in this process, on the same params: the rank's own at
    ``model`` = 1, else the whole draw of ``build_cell`` on one rank's
    mesh): the logits' gap over
    the row's max, the greedy tokens, the top-2 margin of any that
    differ, the gathered cache's gap, the softmax combine's bytes against
    ``modeled_tp_serve_bytes(slot_split=world)``, a decode step's event
    ms (``LONG_TIMED_STEPS`` steps) and the kernels the main path
    launched."""
    import numpy as np
    import torch
    from _tp_cases import compute_dtype
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as Tm
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp as tpm
    from repro_torch.tree import leaves, map_tree, unflatten

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_process_mesh(data=world // model, model=model)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with cut_depth(arch, layers):
        cell = build_cell(arch, shape_name, mesh, smoke=smoke, device=device)
        whole_params = (build_cell(arch, shape_name, make_host_mesh(), smoke=smoke,
                                   device=device).args[0] if model > 1 else cell.args[0])
    cfg, shape = cell.cfg, cell.shape
    params, tok = cell.args[:2]
    with hints.set_mesh(None):
        like = Tm.init_cache(cfg, 1, shape.seq_len, device="meta")
    specs = shd.cache_pspecs(like, cfg, shape, tp=model)
    gen = torch.Generator(device=device).manual_seed(LONG_SEED)
    whole = unflatten(like, [torch.randn(x.shape, generator=gen, device=device).to(x.dtype)
                             for x in leaves(like)])
    placed_shapes = [tuple(x.shape) for x in leaves(cell.args[3])]
    out = {"layers": cfg.num_layers, "placed_shapes": placed_shapes,
           "whole_shapes": [tuple(x.shape) for x in leaves(like)], "positions": {}}
    paid_model = tpm.modeled_tp_serve_bytes(cfg, 1, 1, model, slot_split=world // model)
    launches = None
    for p in (p for p in LONG_POSITIONS if p < shape.seq_len):
        pos = torch.tensor(p, dtype=torch.int32, device=device)
        with torch.no_grad():
            ref, ref_cache = Tm.decode_step(whole_params, cfg, tok, pos,
                                            map_tree(torch.clone, whole))
            reset_launches()
            tpm.tp_counter.reset()
            nxt, cache = cell.step_fn(params, tok, pos, shd.place_cache(whole, specs, cfg, mesh))
            launches = read_launches() if launches is None else {
                k: v + launches[k] for k, v in read_launches().items()}
            paid = dict(tpm.tp_counter.bytes)
            with hints.set_mesh(mesh), hints.replicated_batch():
                logits, _ = Tm.decode_step(params, cfg, tok, pos,
                                           shd.place_cache(whole, specs, cfg, mesh))
            with compute_dtype(torch.float32):  # the same decodes in f32 compute
                ref32, _ = Tm.decode_step(whole_params, cfg, tok, pos,
                                          map_tree(torch.clone, whole))
                with hints.set_mesh(mesh), hints.replicated_batch():
                    mine32, _ = Tm.decode_step(params, cfg, tok, pos,
                                               shd.place_cache(whole, specs, cfg, mesh))
            back = shd.gather_cache(cache, specs, cfg, mesh)
        top2 = torch.topk(ref.float(), 2, dim=-1).values
        scale = ref.float().abs().amax(-1)
        out["positions"][str(p)] = {
            "logits_rel": float(((logits.float() - ref.float()).abs().amax(-1) / scale).max()),
            "f32_logits_rel": float(((mine32 - ref32).abs().amax(-1)
                                     / ref32.abs().amax(-1)).max()),
            "bit_equal": bool(torch.equal(logits, ref)),
            "tokens": nxt.tolist(), "reference_tokens": ref.argmax(-1).tolist(),
            "reference_top2_margin_rel": float(((top2[:, 0] - top2[:, 1]) / scale).min()),
            "cache_rel_max": max(float((a.float() - b.float()).abs().max()
                                       / b.float().abs().max().clamp_min(1e-30))
                                 for a, b in zip(leaves(back), leaves(ref_cache))),
            "combine_bytes": paid, "combine_bytes_equal_model": paid == paid_model,
            "logits": logits.float().cpu()}
    step_ms = []
    if on_card:
        cache = shd.place_cache(whole, specs, cfg, mesh)
        pos = torch.tensor(LONG_POSITIONS[-1], dtype=torch.int32, device=device)
        with torch.no_grad():
            for _ in range(LONG_TIMED_STEPS):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                cell.step_fn(params, tok, pos, cache)
                b.record()
                b.synchronize()
                step_ms.append(a.elapsed_time(b))
    out.update({"mesh": mesh.shape, "combine_bytes_model": paid_model,
                "decode_step_ms": float(np.median(step_ms)) if step_ms else None,
                "launches": launches,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                "alloc_retries": (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                                  if on_card else 0)})
    return out


def long_phase(archs=tuple(LONG)) -> dict:
    """The long phase (phase 21 of the module docstring)."""
    import torch
    from repro_torch.launch.dist import spawn

    t0 = time.perf_counter()
    launches, failed = None, []
    for arch in archs:
        recs = spawn(long_rank, 2, backend="gloo", device="cuda", timeout_s=900,
                     args=(arch, LONG[arch]))
        # no combine to pay: nothing split over data, every rank decodes alike
        exact = recs[0]["combine_bytes_model"]["fwd"] == 0
        ok = not any(r["alloc_retries"] for r in recs)
        for p in recs[0]["positions"]:
            per = [r["positions"][p] for r in recs]
            same = all(torch.equal(per[0]["logits"], q["logits"]) for q in per[1:])
            for q in per:
                q.pop("logits")
                differs = q["tokens"] != q["reference_tokens"]
                ok = ok and same and q["combine_bytes_equal_model"] and (
                    q["f32_logits_rel"] <= LONG_F32_TOL) and (
                    q["bit_equal"] if exact else
                    q["logits_rel"] <= TP_SERVE_LOGIT_TOL
                    and q["cache_rel_max"] <= TP_SERVE_CACHE_TOL
                    and (not differs or q["reference_top2_margin_rel"] <= TP_SERVE_LOGIT_TOL))
        for r, rec in enumerate(recs):
            print(f"long {arch} rank {r}: {json.dumps(rec)}", flush=True)
        arch_launches = {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}
        print(f"long {arch}: {json.dumps({'ranks': 2, 'mesh': {'data': 2, 'model': 1}, 'layers': recs[0]['layers'], 'placed_shapes': recs[0]['placed_shapes'][:2], 'logits_rel': {p: [r['positions'][p]['logits_rel'] for r in recs] for p in recs[0]['positions']}, 'f32_logits_rel': {p: recs[0]['positions'][p]['f32_logits_rel'] for p in recs[0]['positions']}, 'bit_equal_to_data_1': {p: recs[0]['positions'][p]['bit_equal'] for p in recs[0]['positions']}, 'decode_step_ms': [r['decode_step_ms'] for r in recs], 'combine_bytes_model': recs[0]['combine_bytes_model'], 'launches': arch_launches, 'ok': ok})}", flush=True)
        if not ok:
            failed.append(arch)
        launches = arch_launches if launches is None else {
            k: launches[k] + v for k, v in arch_launches.items()}
    wall = time.perf_counter() - t0
    print(f"long: {json.dumps({'phase_wall_s': round(wall, 2), 'launches': launches})}",
          flush=True)
    if failed:
        raise AssertionError(f"long: {failed} failed their checks (the lines above)")
    return {"launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f}s wall, per source "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}", flush=True)
    for name, logtext in _build.BUILD_LOG.items():
        used = sorted({line.split(":", 1)[-1].strip() for line in logtext.splitlines()
                       if "Used" in line or "spill stores" in line})
        print(f"ptxas {name}: {'; '.join(used)}", flush=True)
        for line in logtext.splitlines():
            if "Performance Loss" in line or "warning" in line.lower():
                print(f"ptxas {name}: {line.strip()}", flush=True)
                # the f32 kernel's software pipeline relies on wgmma not
                # being serialized
                if name == "flash_attention_f32_sm90" and "Performance Loss" in line:
                    raise AssertionError(f"ptxas serializes wgmma in {name}.cu")
    sass = _build.sass("flash_attention_sm90")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
    print(f"sass flash_attention_sm90: {json.dumps(counts)}", flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(f"flash_attention_sm90 SASS lacks wgmma or TMA: {counts}")
    sass = _build.sass("flash_attention_f32_sm90")
    counts = {"HGMMA_TF32": len(re.findall(r"\bHGMMA\.\S*\bTF32\b", sass)),
              "UTMALDG": len(re.findall(r"\bUTMALDG\b", sass)),
              # the cluster barrier of the two-block instances (D > 128)
              "UCGABAR_WAIT": len(re.findall(r"\bUCGABAR_WAIT\b", sass))}
    print(f"sass flash_attention_f32_sm90: {json.dumps(counts)}", flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(
            f"flash_attention_f32_sm90 SASS lacks tf32 wgmma, TMA or a cluster barrier: {counts}")
    relayout_sass = _build.sass("relayout")
    div64 = div64_calls(relayout_sass)
    print(f"sass relayout: {json.dumps({'div64_calls': div64})}", flush=True)
    if div64:
        raise AssertionError(f"relayout SASS calls 64-bit division {div64} times")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}  # each phase's wall seconds, for the script's time budget

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t, 2)
        return out

    relayout_rec = timed("relayout", relayout_phase)
    flash_recs = timed("flash", flash_phase)
    f32_routes = timed("f32 path", f32_attention_path)
    launches = {"flash_attention_tf32x3": f32_routes["tf32x3"]}
    timed("moe layer", moe_layer_phase)
    launches.update(timed("serve", serve_phase, "serve"))
    moe = timed("moe serve", serve_phase, "moe serve")
    mla = timed("mla serve", serve_phase, "mla serve")
    ssm = timed("ssm serve", serve_phase, "ssm serve")
    hybrid = timed("hybrid serve", serve_phase, "hybrid serve")
    vlm = timed("vlm decode", vlm_decode_phase)
    audio = timed("audio decode", audio_decode_phase)
    audio_train = timed("audio train", audio_train_phase)
    print(f"kv multicast per position: mla serve F {mla['kv']['F']} ({mla['kv']['F_per_layer']} "
          f"a layer), {mla['kv']['payload_bytes']} B; moe serve F {moe['kv']['F']} "
          f"({moe['kv']['F_per_layer']} a layer), {moe['kv']['payload_bytes']} B; ratio "
          f"{moe['kv']['F'] / mla['kv']['F']:.3f}", flush=True)
    train = timed("train", train_phase)
    ep_train = timed("ep train", ep_train_phase)
    timed("cells", cell_phase)
    dist = timed("dist", dist_phase)
    tp = timed("tp", tp_phase)
    tp_families = timed("tp families", tp_families_phase)
    tp_serve = timed("tp serve", tp_serve_phase)
    long = timed("long", long_phase)
    print(f"phase walls s: {json.dumps(walls)}", flush=True)

    def path_launches(rec):
        return {k: rec.get(k, 0) for k in ("relayout", "flash_attention_wgmma",
                                           "flash_attention_tf32x3")}

    moe_launches, mla_launches = path_launches(moe), path_launches(mla)
    ssm_launches, hybrid_launches = path_launches(ssm), path_launches(hybrid)

    def row(name, source, replaces, rec, bound_by, **extra):
        by_path = {"serve_or_f32": launches[name], "moe_serve": moe_launches[name],
                   "mla_serve": mla_launches[name], "ssm_serve": ssm_launches[name],
                   "hybrid_serve": hybrid_launches[name], "vlm_decode": vlm[name],
                   "audio_decode": audio[name], "audio_train": audio_train[name],
                   "train": train["train_launches"][name],
                   "ep_train": ep_train["train_launches"][name],
                   "dist_train": dist["train_launches"][name],
                   "ep_dist_train": dist["ep_launches"][name],
                   "tp_train": tp["train_launches"][name],
                   "tp_families_train": tp_families["train_launches"][name],
                   "tp_serve": tp_serve["serve_launches"][name],
                   "long_serve": long["launches"][name]}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": bound_by, "library_ms": rec["library_ms"],
            "device_ms": rec["device_ms"], "library_device_ms": rec["library_device_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"], **extra,
        }

    flash_replaces = "src/repro/kernels/flash_attention/kernel.py:100"
    wgmma_rec, tf32x3_rec = flash_recs["yi6b_prefill"], flash_recs["yi6b_prefill_f32"]

    def sub(name):
        return {k: flash_recs[name][k] for k in (
            "shape", "dtype", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by", "max_abs_err")}

    kernels = [
        row("relayout", "src/repro_torch/csrc/relayout.cu",
            "src/repro/kernels/relayout/kernel.py:55", relayout_rec, "bytes",
            launches_by_route=launches["relayout_by_route"],
            launches_by_route_moe_serve=moe["relayout_by_route"],
            launches_by_route_mla_serve=mla["relayout_by_route"],
            device_ms_cold=relayout_rec["device_ms_cold"],
            library_device_ms_cold=relayout_rec["library_device_ms_cold"]),
        row("flash_attention_wgmma", "src/repro_torch/csrc/flash_attention_sm90.cu",
            flash_replaces, wgmma_rec, wgmma_rec["bound_by"],
            dsmoe_prefill=sub("dsmoe_prefill"), jamba_prefill=sub("jamba_prefill"),
            qwen2vl_prefill=sub("qwen2vl_prefill"),
            yi6b_tp2_rank=sub("yi6b_tp2_rank"), jamba_tp2_rank=sub("jamba_tp2_rank"),
            yi6b_tp4_rank=sub("yi6b_tp4_rank"), jamba_tp4_rank=sub("jamba_tp4_rank"),
            yi6b_tp2_slot=sub("yi6b_tp2_slot"), jamba_tp2_slot=sub("jamba_tp2_slot"),
            yi6b_tp4_slot=sub("yi6b_tp4_slot"), jamba_tp4_slot=sub("jamba_tp4_slot"),
            qwen2vl_tp2_rank=sub("qwen2vl_tp2_rank"), qwen2vl_tp4_rank=sub("qwen2vl_tp4_rank"),
            bf16_d40=sub("bf16_d40"),
            d80_gqa=sub("d80_gqa")),
        row("flash_attention_tf32x3", "src/repro_torch/csrc/flash_attention_f32_sm90.cu",
            flash_replaces, tf32x3_rec, tf32x3_rec["bound_by"],
            bound_ms_cuda_cores=tf32x3_rec["bound_ms_cuda_cores"],
            split_device_ms=tf32x3_rec["split_device_ms"],
            f32_d192_4k=sub("f32_d192_4k")),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
