"""Architecture / shape configuration dataclasses (the port's own copy of
``repro/configs/base.py``, which is pure Python; the port imports nothing
of ``repro``).

Every ported architecture gets one ``src/repro_torch/configs/<id>.py``
exporting ``get_config()`` -> :class:`ArchConfig` with the exact assigned
hyper-parameters, plus ``get_smoke_config()`` -> a reduced variant of the
same family (<=2 layers, d_model<=512, <=4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    source: str  # citation from the assignment table

    # transformer trunk
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavor
    attn_pattern: str = "full"  # full | swa | local_global
    sliding_window: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False  # Qwen2-VL multimodal 3-axis RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t,h,w halves of head_dim//2

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (if different from dense d_ff)
    moe_every: int = 1  # a layer is MoE iff layer_idx % moe_every == moe_offset
    moe_offset: int = 0
    first_layer_dense: bool = False  # deepseek-v2: layer 0 dense
    router_mode: str = "dense"  # dense (exact einsum) | capacity (scatter EP)
    capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: one attn layer per `attn_every` layers (jamba: 8)
    attn_offset: int = 4  # position of the attn layer inside the period

    # encoder-decoder (seamless)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # modality frontend (stubbed per DESIGN.md §5)
    modality: str = "text"  # text | vision_stub | audio_stub

    # norms / misc
    norm_eps: float = 1e-6
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    post_attn_norm: bool = False  # gemma2 uses pre+post norms
    embed_scale: bool = False  # gemma: scale embeds by sqrt(d_model)

    # training-side defaults
    optimizer: str = "adamw"  # adamw | adamw_bf16 | adafactor
    remat: bool = True
    param_dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 for clean ("model",) sharding."""
        return _round_up(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, idx: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.first_layer_dense and idx == 0:
            return False
        return idx % self.moe_every == self.moe_offset

    def is_attn_layer(self, idx: int) -> bool:
        """hybrid/ssm layer-type pattern; True for all layers of attn archs."""
        if self.family == "ssm":
            return False
        if self.attn_every:
            return idx % self.attn_every == self.attn_offset
        return True

    def is_global_attn_layer(self, idx: int) -> bool:
        """gemma2-style alternation: odd layers global, even layers local."""
        if self.attn_pattern == "local_global":
            return idx % 2 == 1
        return self.attn_pattern == "full"

    # ---- analytic parameter counts (used in roofline MODEL_FLOPS) ----
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        total = 0
        for i in range(L):
            lp = 0
            if self.family == "ssm" or (self.attn_every and not self.is_attn_layer(i)):
                # mamba2 block: in_proj (d -> 2*dI + 2*G*N + H) + out + conv + dt
                dI, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                lp += d * (2 * dI + 2 * N + H) + dI * d + dI * self.ssm_conv + 2 * H
            else:
                if self.use_mla:
                    r, qk_r = self.kv_lora_rank, self.qk_rope_head_dim
                    qd = self.n_heads * (self.qk_nope_head_dim + qk_r)
                    lp += d * self.q_lora_rank + self.q_lora_rank * qd  # q path
                    lp += d * (r + qk_r)  # kv down
                    lp += r * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    lp += self.n_heads * self.v_head_dim * d  # o proj
                else:
                    lp += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.is_moe_layer(i):
                e_ff = self.moe_d_ff or self.d_ff
                n_e = (self.moe_top_k if active_only else self.n_experts)
                lp += (n_e + self.n_shared_experts) * 3 * d * e_ff
                lp += d * self.n_experts  # router
            elif self.d_ff:
                lp += 3 * d * self.d_ff
            total += lp
            per_layer = lp
        del per_layer
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder already counted above,
            # add cross-attention per decoder layer
            enc = self.n_enc_layers * (2 * (d * self.q_dim + 2 * d * self.kv_dim
                                            + self.q_dim * d) // 2 + 3 * d * self.d_ff)
            total += enc + L * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return total + emb

    def model_flops_per_token(self) -> float:
        """6*N (active) per token, the roofline MODEL_FLOPS convention."""
        return 6.0 * self.param_count(active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke_reduce(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    small: dict = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=64,
    )
    if cfg.n_experts:
        small.update(
            n_experts=4,
            moe_top_k=min(cfg.moe_top_k, 2),
            n_shared_experts=min(cfg.n_shared_experts, 1),
            moe_d_ff=256 if cfg.moe_d_ff else 0,
        )
    if cfg.use_mla:
        small.update(kv_lora_rank=64, q_lora_rank=96, qk_nope_head_dim=32,
                     qk_rope_head_dim=16, v_head_dim=64, head_dim=48)
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.attn_every:
        # keep the hybrid 7:1 flavor but at 2 layers: 1 mamba + 1 attn
        small.update(n_layers=2, attn_every=2, attn_offset=1, moe_every=2,
                     moe_offset=1)
    if cfg.is_encoder_decoder:
        small.update(n_enc_layers=2)
    small.update(name=cfg.name + "-smoke", remat=False, param_dtype="float32",
                 router_mode="dense")
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
