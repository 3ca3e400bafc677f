"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,  # MLA: per-assignment GQA kv=128 (full heads, latent-compressed)
        head_dim=128,
        d_ff=12288,  # dense-layer hidden (layer 0)
        vocab_size=102400,
        attn_pattern="full",
        rope_theta=10000.0,
        n_experts=160,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        moe_every=1,
        first_layer_dense=True,
        router_mode="capacity",
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        optimizer="adafactor",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
