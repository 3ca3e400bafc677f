"""gemma2-9b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b",
        family="dense",
        source="arXiv:2408.00118",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        attn_pattern="local_global",
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        rope_theta=10000.0,
        post_attn_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        optimizer="adamw",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
