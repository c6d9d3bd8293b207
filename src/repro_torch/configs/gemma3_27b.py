"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144. 5:1 local(window 1024):global, dual RoPE theta, QK-norm.
[hf:google/gemma-3-1b-pt family card]
"""
from repro_torch.config import ModelConfig

PATTERN = ('local', 'local', 'local', 'local', 'local', 'global')


def config() -> ModelConfig:
    return ModelConfig(
        name='gemma3-27b', arch_class='dense', num_layers=62, d_model=5376,
        num_heads=32, num_kv_heads=16, head_dim=128, d_ff=21504,
        vocab_size=262144, pattern=PATTERN, window=1024,
        pos='rope', rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        qk_norm=True, embed_scale=True, act='gelu_tanh', glu=True,
        tie_embeddings=True, max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='gemma3-27b-smoke', arch_class='dense', num_layers=2,
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=503, pattern=PATTERN, window=8, pos='rope',
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, qk_norm=True,
        embed_scale=True, act='gelu_tanh', glu=True, tie_embeddings=True,
        max_seq_len=512, dtype='float32')
