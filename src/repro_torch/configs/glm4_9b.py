"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE, SwiGLU, untied embeddings. [hf:THUDM/glm-4-9b]
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='glm4-9b', arch_class='dense', num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=2, head_dim=128, d_ff=13696,
        vocab_size=151552, pos='rope', rope_theta=10_000.0, act='silu',
        glu=True, tie_embeddings=False, max_seq_len=131072)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='glm4-9b-smoke', arch_class='dense', num_layers=2, d_model=128,
        num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=503,
        pos='rope', rope_theta=10_000.0, act='silu', glu=True,
        tie_embeddings=False, max_seq_len=512, dtype='float32')
