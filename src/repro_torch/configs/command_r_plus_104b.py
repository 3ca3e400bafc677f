"""command-r-plus-104b [dense] — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-104b",
        family="dense",
        source="hf:CohereForAI/c4ai-command-r-v01",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256000,
        attn_pattern="full",
        qkv_bias=False,
        rope_theta=75_000_000.0,
        tie_embeddings=True,
        optimizer="adafactor",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
