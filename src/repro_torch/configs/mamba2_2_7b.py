"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,  # attention-free, no separate FFN: the mamba block is the mixer+MLP
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=256,
        norm_type="rmsnorm",
        optimizer="adamw",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config(), n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0)
