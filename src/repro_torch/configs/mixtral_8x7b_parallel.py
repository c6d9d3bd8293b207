"""Hypothetical parallel-residual Mixtral-8x7B — the paper's §3 third column.

Identical to mixtral-8x7b but with parallel attention/FFN blocks, which lets
the *entire switch-FFN* (all 8 experts' worth of weights: 1.43B) fold into
the precomputed table -> first-layer read reduction 140,084x at batch 1 and a
NET MEMORY DECREASE of 3% (the table grows by less than the eliminated
expert weights).
"""
from repro_torch.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='mixtral-8x7b-parallel', arch_class='moe', num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000, block_type='parallel',
        pattern=('local',), window=4096, pos='rope', rope_theta=1_000_000.0,
        act='silu', glu=True, tie_embeddings=False,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                      capacity_factor=1.25),
        max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='mixtral-8x7b-parallel-smoke', arch_class='moe', num_layers=2,
        d_model=128, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256,
        vocab_size=503, block_type='parallel', pattern=('local',), window=8,
        pos='rope', act='silu', glu=True, tie_embeddings=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0),
        max_seq_len=512, dtype='float32')
