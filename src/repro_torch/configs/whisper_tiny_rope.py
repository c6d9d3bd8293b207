"""whisper-tiny-rope — beyond-paper variant: Whisper-tiny backbone with a
RoPE decoder, which re-enables the paper's first-layer precompute (decoder
self-attn Q/K/V). The paper's abstract uses 4-layer Whisper-tiny as the
"max 25% savings" example — that bound presumes this RoPE-ized form.
"""
from repro_torch.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='whisper-tiny-rope', arch_class='audio', num_layers=4,
        d_model=384, num_heads=6, num_kv_heads=6, head_dim=64, d_ff=1536,
        vocab_size=51865, pos='rope', rope_theta=10_000.0, norm='layernorm',
        act='gelu', glu=False, tie_embeddings=True,
        encoder=EncoderConfig(kind='audio', num_layers=4, d_model=384,
                              num_heads=6, num_kv_heads=6, d_ff=1536,
                              source_len=1500, frontend_dim=384),
        max_seq_len=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='whisper-tiny-rope-smoke', arch_class='audio', num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=503, pos='rope', norm='layernorm', act='gelu', glu=False,
        tie_embeddings=True,
        encoder=EncoderConfig(kind='audio', num_layers=2, d_model=64,
                              num_heads=4, num_kv_heads=4, d_ff=128,
                              source_len=30, frontend_dim=64),
        max_seq_len=512, dtype='float32')
