"""Unified model configuration covering all assigned architecture families.

One fat dataclass rather than a hierarchy: every assigned arch is a
decoder-LM-style backbone whose layers differ only in (a) the sequence
mixer (GQA / MLA / Mamba-2 SSD), (b) the FFN (dense SwiGLU / GeLU /
fine-grained MoE), and (c) the positional scheme (RoPE / M-RoPE /
learned). ``layer_groups`` compiles the per-layer pattern into
scan-friendly homogeneous groups (see models/transformer.py).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
Mixer = Literal["gqa", "mla", "mamba"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer
    ffn: Ffn
    cross_attention: bool = False  # whisper decoder layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads

    # positional / attention behaviour
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # SWA width (h2o-danube)
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE
    qkv_bias: bool = False  # qwen2 family
    attention: Literal["gqa", "mla"] = "gqa"
    # 'rope' | 'mrope' | 'learned' (whisper) | 'none' (jamba attn layers)
    pos_scheme: Literal["rope", "mrope", "learned", "none"] = "rope"
    max_position_embeddings: int = 0  # learned-PE table size (audio)

    # MLA (deepseek-v2-lite)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 = full-rank Q (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_stride: int = 1  # MoE every k-th layer (jamba: 2)
    first_layer_dense: bool = False  # deepseek family
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001

    # hybrid (jamba): attention layer at i % attn_period == attn_offset
    attn_period: int = 0  # 0 = not hybrid
    attn_offset: int = 4

    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 1500  # precomputed frame embeddings (stub frontend)

    # numerics
    norm_eps: float = 1e-5
    ffn_activation: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    # 'reference' materializes S² scores; 'chunked' is the lowerable
    # online-softmax flash twin; 'flash' is the hand-written CUDA kernel.
    attn_impl: Literal["reference", "flash", "chunked"] = "reference"
    attn_chunk: int = 1024  # KV chunk for attn_impl='chunked'
    # MLA decode: score against the compressed cache directly (absorb
    # W_uk into Q / W_uv into the output) instead of recovering K/V —
    # beyond-paper optimization, exact same math.
    mla_absorb: bool = False
    # MoE dispatch/combine wire in bf16 with f32 accumulation only at
    # the per-token top-k sum (halves dispatch traffic; same routing).
    moe_bf16_wire: bool = False
    # norms: keep the (B,S,d) tensors bf16 (variance still f32) — the
    # production-framework trade; f32 everywhere is the faithful default.
    bf16_norm: bool = False
    # shard attention over the query-sequence dim instead of heads —
    # for archs whose head count doesn't divide the TP axis (qwen: 28).
    attn_seq_shard: bool = False
    # route/dispatch MoE per batch row: row-local scatter indices let
    # GSPMD shard expert flops over DP × EP (see moe_apply_rowwise).
    moe_row_dispatch: bool = False
    # expert-parallel MoE over the DP axes with Torrent chain
    # all-to-all dispatch/combine (see moe_apply_ep); requires the DP
    # group size to divide num_experts and the batch, else falls back
    # to the flat path.
    moe_ep_dispatch: bool = False
    # K sub-rings for the EP dispatch exchange (multi-chain all-to-all).
    moe_ep_chains: int = 1
    # ship the EP dispatch/return token payloads int8-quantized per hop
    # (wire_dtype="int8" through torrent_all_to_all); expert-id
    # metadata always travels exact.
    moe_ep_int8_wire: bool = False

    # --- derived -------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_spec(self, i: int) -> LayerSpec:
        """The (mixer, ffn) of decoder layer ``i``."""
        if self.family == "ssm":
            return LayerSpec(mixer="mamba", ffn="none")
        if self.attn_period:  # hybrid (jamba)
            mixer: Mixer = (
                "gqa" if i % self.attn_period == self.attn_offset else "mamba"
            )
        else:
            mixer = self.attention
        ffn: Ffn = "dense"
        if self.num_experts:
            is_moe = i % self.moe_layer_stride == self.moe_layer_stride - 1 \
                if self.moe_layer_stride > 1 else True
            if self.first_layer_dense and i == 0:
                is_moe = False
            if is_moe:
                ffn = "moe"
        return LayerSpec(
            mixer=mixer, ffn=ffn, cross_attention=self.is_encdec
        )

    def layer_groups(self) -> list[tuple[tuple[LayerSpec, ...], int]]:
        """Compile per-layer specs into (pattern, repeat) groups so that
        heterogeneous stacks (hybrid/MoE-with-dense-first) scan with a
        small traced pattern. Greedy: find the shortest period that
        tiles the remaining layers."""
        specs = [self.layer_spec(i) for i in range(self.num_layers)]
        groups: list[tuple[tuple[LayerSpec, ...], int]] = []
        i = 0
        while i < len(specs):
            rest = specs[i:]
            best: tuple[tuple[LayerSpec, ...], int] | None = None
            # Prefer genuinely repeating patterns (reps >= 2, smallest
            # period on coverage ties) so the traced body stays small;
            # a pattern that never repeats is emitted layer-by-layer.
            for period in range(1, len(rest) // 2 + 1):
                pattern = tuple(rest[:period])
                reps = 1
                while (reps + 1) * period <= len(rest) and tuple(
                    rest[reps * period : (reps + 1) * period]
                ) == pattern:
                    reps += 1
                if reps >= 2 and (
                    best is None or reps * period > best[1] * len(best[0])
                ):
                    best = (pattern, reps)
            if best is None:
                best = ((rest[0],), 1)
            pattern, reps = best
            groups.append((pattern, reps))
            i += reps * len(pattern)
        return groups
