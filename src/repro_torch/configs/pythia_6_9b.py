"""pythia-6.9b — the paper's §3 *parallel* example. [arXiv:2304.01373]

GPT-NeoX architecture: parallel attention/FFN residual (two LayerNorms),
MHA 32 heads, rotary PE, 2-layer GELU MLP (no GLU), untied embeddings,
vocab 50,400 (the paper's table value).

This is the headline case: with parallel blocks the FFN + skip fold into the
table too — first-layer read reduction 11,264x at batch 1 (paper table 2).
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='pythia-6.9b', arch_class='dense', num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=32, head_dim=128, d_ff=16384,
        vocab_size=50400, block_type='parallel', norm='layernorm',
        act='gelu', glu=False, pos='rope', rope_theta=10_000.0,
        tie_embeddings=False, max_seq_len=2048)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='pythia-6.9b-smoke', arch_class='dense', num_layers=2,
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
        vocab_size=503, block_type='parallel', norm='layernorm', act='gelu',
        glu=False, pos='rope', tie_embeddings=False, max_seq_len=512,
        dtype='float32')
