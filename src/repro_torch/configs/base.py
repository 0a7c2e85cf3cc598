"""Dataclass config system (counterpart of `repro.configs.base`, same
fields and defaults, so configs translate one to one).

One `ModelConfig` describes any architecture in the zoo (dense / MoE / SSM /
hybrid / enc-dec / VLM); `RunConfig` adds step-shape + policy knobs. Every
ported architecture contributes a module `configs/<id>.py` exposing `CONFIG`
(the published numbers) and `SMOKE` (a reduced same-family variant for CPU
tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.policy import FTConfig, ONLINE_BLOCK


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    #: Arctic-style parallel dense residual FFN width (0 = none).
    dense_d_ff: int = 0
    #: GShard dispatch group size (tokens). Smaller ⇒ less dispatch-einsum
    #: FLOPs overhead but more capacity variance. Hillclimb lever.
    #: (padded dispatch only — the grouped path has no capacity geometry.)
    group_size: int = 512
    capacity_factor: float = 1.25
    #: Expert dispatch: "grouped" (default — ragged ft_grouped_matmul
    #: over a row-sorted token buffer, zero capacity padding, no dropped
    #: tokens) or "padded" (the GShard capacity-einsum baseline, kept for
    #: the moe_dispatch benchmark comparison).
    dispatch: str = "grouped"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 128          # N — SSM state dimension
    head_dim: int = 64        # P — channels per SSD head
    expand: int = 2           # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256          # SSD chunk length (training scan)
    n_groups: int = 1         # B/C groups


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    #: hybrid: one shared attention block applied every `attn_every` SSM blocks
    attn_every: int = 6
    #: encdec: encoder depth (n_layers counts decoder); audio frame count
    enc_layers: int = 0
    n_audio_frames: int = 1500
    #: vlm: number of prepended image-patch embeddings (stub frontend)
    n_patches: int = 576
    #: attention-free archs have no KV cache / quadratic attention
    attention_free: bool = False
    #: supports sub-quadratic long-context decode (SSM / hybrid)
    subquadratic: bool = False

    @property
    def qkv_dims(self) -> Tuple[int, int]:
        return (self.n_heads * self.head_dim,
                self.n_kv_heads * self.head_dim)

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape × step-kind) cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    ft: FTConfig = ONLINE_BLOCK
    dtype: str = "bfloat16"
    # training
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0
    #: optimizer state dtype: "f32" (AdamW), "q8" (int8 m/v — memory-sharded
    #: huge models; see DESIGN.md on arctic-480b fitting a 256-chip pod)
    opt_state: str = "f32"
    remat: str = "full"       # "none" | "full"
    microbatch: int = 0       # 0 = no gradient accumulation
    # attention sharding scheme: "heads" (TP over heads, GSPMD-padded when
    # head count ∤ mesh) | "none" (batch-only). Hillclimb lever.
    attn_shard: str = "heads"
    attn_chunk: int = 512     # query-chunk for flash-style attention scan
    # attention core: "auto" (flashft kernel on the pallas FT backend,
    # chunked-jnp scan elsewhere) | "flash" | "chunked" (force the oracle).
    attn_impl: str = "auto"
    seed: int = 0
