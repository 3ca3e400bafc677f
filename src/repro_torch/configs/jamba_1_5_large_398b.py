"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        source="arXiv:2403.19887",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        attn_pattern="full",  # attn layers are full-attention; long-ctx uses window (DESIGN §5)
        sliding_window=4096,
        n_experts=16,
        moe_top_k=2,
        moe_d_ff=24576,
        moe_every=2,  # MoE on every other layer (e=2 in the Jamba paper)
        moe_offset=1,
        router_mode="capacity",
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=256,
        attn_every=8,  # one attention layer per 8 (1:7 attn:mamba)
        attn_offset=4,
        optimizer="adafactor",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
