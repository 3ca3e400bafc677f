"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        source="arXiv:2401.16818",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        attn_pattern="swa",
        sliding_window=4096,
        rope_theta=10000.0,
        optimizer="adamw",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
