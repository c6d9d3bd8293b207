"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local(sliding-window 512):global interleave, dual RoPE theta (10k local /
1M global), QK-RMSNorm, sqrt(d) embedding scale, tied embeddings.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.config import ModelConfig

PATTERN = ('local', 'local', 'local', 'local', 'local', 'global')


def config() -> ModelConfig:
    return ModelConfig(
        name='gemma3-1b', arch_class='dense', num_layers=26, d_model=1152,
        num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912,
        vocab_size=262144, pattern=PATTERN, window=512,
        pos='rope', rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        qk_norm=True, embed_scale=True, act='gelu_tanh', glu=True,
        tie_embeddings=True, max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='gemma3-1b-smoke', arch_class='dense', num_layers=2, d_model=96,
        num_heads=4, num_kv_heads=1, head_dim=32, d_ff=192, vocab_size=503,
        pattern=PATTERN, window=8, pos='rope', rope_theta=1_000_000.0,
        rope_theta_local=10_000.0, qk_norm=True, embed_scale=True,
        act='gelu_tanh', glu=True, tie_embeddings=True, max_seq_len=512,
        dtype='float32')
