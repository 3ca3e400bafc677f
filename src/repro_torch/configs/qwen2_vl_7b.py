"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision encoder is a stub: a batch carries merged (text + patch)
embeddings and 3-axis M-RoPE positions; this config describes the language
backbone that consumes them.
"""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        source="arXiv:2409.12191",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        attn_pattern="full",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope=True,
        mrope_sections=(16, 24, 24),  # sums to head_dim//2 = 64
        modality="vision_stub",
        optimizer="adamw",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config(), mrope_sections=(8, 12, 12))
