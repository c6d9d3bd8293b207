"""xlstm-125m [ssm] — 12L d_model=768 vocab=50304, alternating mLSTM/sLSTM
blocks, no positional encoding (recurrence carries order). [arXiv:2405.04517]

Paper relevance (beyond-paper): with NO positional encoding at all, even more
of block 1 is precomputable than in the RoPE case — the mLSTM up-projection,
value projection and i/f gate pre-activations; the sLSTM z/o gate inputs.
Causal convs and recurrences stay at runtime. Sub-quadratic -> runs long_500k.
"""
from repro_torch.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name='xlstm-125m', arch_class='ssm', num_layers=12, d_model=768,
        num_heads=4, num_kv_heads=4, head_dim=192, d_ff=0, vocab_size=50304,
        pattern=('mlstm', 'slstm'), pos='none', tie_embeddings=True,
        ssm=SSMConfig(conv_kernel=4, expand=2, num_ssm_heads=4),
        max_seq_len=1048576)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name='xlstm-125m-smoke', arch_class='ssm', num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=0, vocab_size=503,
        pattern=('mlstm', 'slstm'), pos='none', tie_embeddings=True,
        ssm=SSMConfig(conv_kernel=4, expand=2, num_ssm_heads=4),
        max_seq_len=512, dtype='float32')
