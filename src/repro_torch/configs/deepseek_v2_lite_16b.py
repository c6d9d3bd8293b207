"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora_rank=512, 64 routed experts top-6 + 2 shared,
first layer dense FFN (hidden 10944). [arXiv:2405.04434]

NOTE on the assignment brackets: they say both "MoE 64e top-6" and "2 shared
+160 routed". DeepSeek-V2-**Lite** has 64 routed experts (160 is V2-full);
we follow the model card + the "64e top-6" text.

MLA + the paper: q, the compressed latent c_kv, and the decoupled k_pe are
all position-independent -> precomputable (row = [x, q, c_kv, k_pe]).
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='deepseek-v2-lite-16b', arch_class='moe', num_layers=27,
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=10944, vocab_size=102400, pos='rope', rope_theta=10_000.0,
        act='silu', glu=True, tie_embeddings=False,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared=2, first_dense_layers=1, dense_d_ff=10944,
                      capacity_factor=1.25),
        max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='deepseek-v2-lite-smoke', arch_class='moe', num_layers=2,
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
        vocab_size=503, pos='rope', rope_theta=10_000.0, act='silu',
        glu=True, tie_embeddings=False,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, num_shared=1,
                      first_dense_layers=1, dense_d_ff=256,
                      capacity_factor=2.0),
        max_seq_len=512, dtype='float32')
