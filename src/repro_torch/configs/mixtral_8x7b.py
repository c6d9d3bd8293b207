"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]

Serial blocks -> the paper's precompute covers Q/K/V only (the MoE FFN stays
at runtime), exactly as the paper's §2 notes for Mixtral.
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='mixtral-8x7b', arch_class='moe', num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=32000, pattern=('local',), window=4096, pos='rope',
        rope_theta=1_000_000.0, act='silu', glu=True, tie_embeddings=False,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                      capacity_factor=1.25),
        max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='mixtral-8x7b-smoke', arch_class='moe', num_layers=2,
        d_model=128, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256,
        vocab_size=503, pattern=('local',), window=8, pos='rope',
        rope_theta=1_000_000.0, act='silu', glu=True, tie_embeddings=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0),
        max_seq_len=512, dtype='float32')
