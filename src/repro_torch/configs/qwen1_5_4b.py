"""qwen1.5-4b [dense] — QKV bias, MHA [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        attn_pattern="full",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        optimizer="adamw",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config(), n_kv_heads=4)
