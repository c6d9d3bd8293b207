"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads in every block,
128 learnable meta tokens, sliding window (1024) with periodic global layers.
[arXiv:2411.13676]

Simplification noted in DESIGN.md: Hymba puts full attention at the
first/middle/last layers; our periodic pattern machinery places the global
layers at 0 and 16 (pattern of 16 = 1 global + 15 windowed).

Paper relevance: both branch in-projections (attn q/k/v pre-RoPE, mamba
in/gate) are position-independent -> precomputable.
"""
from repro_torch.config import ModelConfig, SSMConfig

PATTERN = ('hybrid_global',) + ('hybrid',) * 15


def config() -> ModelConfig:
    return ModelConfig(
        name='hymba-1.5b', arch_class='hybrid', num_layers=32, d_model=1600,
        num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504,
        vocab_size=32001, pattern=PATTERN, window=1024, pos='rope',
        rope_theta=10_000.0, act='silu', glu=True, tie_embeddings=True,
        num_meta_tokens=128,
        ssm=SSMConfig(conv_kernel=4, state_dim=16, num_ssm_heads=25),
        max_seq_len=1048576)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='hymba-1.5b-smoke', arch_class='hybrid', num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=503, pattern=('hybrid_global', 'hybrid'), window=8,
        pos='rope', rope_theta=10_000.0, act='silu', glu=True,
        tie_embeddings=True, num_meta_tokens=4,
        ssm=SSMConfig(conv_kernel=4, state_dim=8, num_ssm_heads=4),
        max_seq_len=512, dtype='float32')
