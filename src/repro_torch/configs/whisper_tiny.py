"""whisper-tiny [audio] — 4L decoder d_model=384 6H (MHA) d_ff=1536
vocab=51865, encoder-decoder with conv/mel frontend STUB (input_specs
provides 1500 frame embeddings). [arXiv:2212.04356]

Faithful Whisper uses *learned absolute PE* in the decoder — which, per the
paper's §2 / Figure 2(a), BLOCKS first-layer precompute
(``precompute_supported=False``). See ``whisper_tiny_rope`` for the
RoPE-ized variant the paper's abstract alludes to (25% bound at 4 layers).
"""
from repro_torch.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='whisper-tiny', arch_class='audio', num_layers=4, d_model=384,
        num_heads=6, num_kv_heads=6, head_dim=64, d_ff=1536,
        vocab_size=51865, pos='learned', norm='layernorm', act='gelu',
        glu=False, tie_embeddings=True, precompute_supported=False,
        encoder=EncoderConfig(kind='audio', num_layers=4, d_model=384,
                              num_heads=6, num_kv_heads=6, d_ff=1536,
                              source_len=1500, frontend_dim=384),
        max_seq_len=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='whisper-tiny-smoke', arch_class='audio', num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=503, pos='learned', norm='layernorm', act='gelu',
        glu=False, tie_embeddings=True, precompute_supported=False,
        encoder=EncoderConfig(kind='audio', num_layers=2, d_model=64,
                              num_heads=4, num_kv_heads=4, d_ff=128,
                              source_len=30, frontend_dim=64),
        max_seq_len=512, dtype='float32')
