"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. InternViT vision encoder STUB (input_specs provides 256 patch
features, dim 1024) + real MLP projector + Qwen2-0.5B-style LM backbone.
[arXiv:2404.16821]

Paper relevance: hybrid precompute — text tokens gather from the table,
image patches (continuous) compute layer-0 projections on the fly.
"""
from repro_torch.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='internvl2-1b', arch_class='vlm', num_layers=24, d_model=896,
        num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864,
        vocab_size=151655, pos='rope', rope_theta=1_000_000.0, act='silu',
        glu=True, tie_embeddings=True,
        encoder=EncoderConfig(kind='vision', source_len=256,
                              frontend_dim=1024),
        max_seq_len=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='internvl2-1b-smoke', arch_class='vlm', num_layers=2,
        d_model=112, num_heads=7, num_kv_heads=1, head_dim=16, d_ff=224,
        vocab_size=503, pos='rope', rope_theta=1_000_000.0, act='silu',
        glu=True, tie_embeddings=True,
        encoder=EncoderConfig(kind='vision', source_len=8, frontend_dim=32),
        max_seq_len=512, dtype='float32')
