"""mistral-7b — the paper's §3 *serial* example. [arXiv:2310.06825]

GQA (32H / 8 KV), SwiGLU FFN (hidden 14336), sliding-window 4096, RoPE,
vocab 32,000 — first-layer read reduction 2,458x at batch 1 (paper table 2),
total memory +2%.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='mistral-7b', arch_class='dense', num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=32000, pattern=('local',), window=4096, pos='rope',
        rope_theta=10_000.0, act='silu', glu=True, tie_embeddings=False,
        max_seq_len=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='mistral-7b-smoke', arch_class='dense', num_layers=2,
        d_model=128, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256,
        vocab_size=503, pattern=('local',), window=8, pos='rope',
        act='silu', glu=True, tie_embeddings=False, max_seq_len=512,
        dtype='float32')
