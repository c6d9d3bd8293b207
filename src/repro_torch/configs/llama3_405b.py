"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. Full causal attention, RoPE theta 500k, untied embeddings.
[arXiv:2407.21783]
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='llama3-405b', arch_class='dense', num_layers=126,
        d_model=16384, num_heads=128, num_kv_heads=8, head_dim=128,
        d_ff=53248, vocab_size=128256, pos='rope', rope_theta=500_000.0,
        act='silu', glu=True, tie_embeddings=False, max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='llama3-405b-smoke', arch_class='dense', num_layers=2,
        d_model=128, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256,
        vocab_size=503, pos='rope', rope_theta=500_000.0, act='silu',
        glu=True, tie_embeddings=False, max_seq_len=512, dtype='float32')
