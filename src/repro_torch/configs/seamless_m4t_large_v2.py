"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

The speech frontend (mel + conformer feature extractor) is a stub: a batch
carries frame embeddings (batch, frames, d_model); this config is the
text-decoder/speech-encoder transformer.
"""
from repro_torch.configs.base import ArchConfig, smoke_reduce


def get_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        source="arXiv:2308.11596",
        n_layers=24,  # decoder layers
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,  # padded to 256256 for sharding (vocab_padded)
        attn_pattern="full",
        is_encoder_decoder=True,
        modality="audio_stub",
        norm_type="layernorm",
        rope_theta=10000.0,
        optimizer="adamw",
    )


def get_smoke_config() -> ArchConfig:
    return smoke_reduce(get_config())
