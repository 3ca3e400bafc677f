"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        source="arXiv:2401.04088",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        attn_pattern="swa",
        sliding_window=4096,
        rope_theta=1_000_000.0,
        n_experts=8,
        moe_top_k=2,
        moe_d_ff=16384,
        moe_every=1,
        router_mode="capacity",
        optimizer="adafactor",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
