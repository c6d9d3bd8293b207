"""Model / run configuration system.

A copy of the JAX package's ``repro.config``: the port keeps its own so that it
never imports the JAX package. Every architecture in ``repro_torch.configs``
builds a :class:`ModelConfig`, a frozen (hashable) dataclass.

Layer *patterns*: architectures with heterogeneous layers (gemma3's 5 local : 1
global, xLSTM's mLSTM/sLSTM alternation, hymba's uniform hybrid blocks) declare a
repeating ``pattern`` of per-layer kinds. The transformer stacks parameters per
pattern *slot* and loops over pattern repetitions; each slot keeps its own
static structure (window size, cache length, block kind).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (Switch-style capacity dispatch)."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    first_dense_layers: int = 0     # leading layers that use a dense FFN instead
    dense_d_ff: int = 0             # d_ff of those dense layers (0 -> cfg.d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = full-rank Q projection (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Recurrent-block configuration (xLSTM blocks / Mamba-style heads)."""
    conv_kernel: int = 4
    state_dim: int = 16             # mamba SSM state size N
    expand: int = 2                 # up-projection factor for mamba / mLSTM
    num_ssm_heads: int = 4          # heads for mLSTM / sLSTM / hymba mamba side
    proj_factor_slstm: float = 4.0 / 3.0  # sLSTM ffn-style factor


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Modality frontend + encoder (Whisper audio / InternVL vision).

    The *frontend* (mel+conv, or ViT) is a STUB per the assignment:
    ``input_specs`` provides precomputed frame/patch embeddings with feature
    dimension ``frontend_dim``; a real (learned) linear projector maps them to
    the encoder/LM width.
    """
    kind: str                       # 'audio' | 'vision'
    num_layers: int = 0             # 0 -> vision stub has no extra encoder stack
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    source_len: int = 1500          # audio frames or image patches
    frontend_dim: int = 384         # stub feature dim handed to the projector
    pos: str = 'sincos'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_class: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # ---- block structure ----
    block_type: str = 'serial'      # 'serial' | 'parallel' (attn/ffn in parallel)
    norm: str = 'rmsnorm'           # 'rmsnorm' | 'layernorm'
    act: str = 'silu'
    glu: bool = True                # GLU-variant FFN (SwiGLU etc.)
    # ---- layer pattern ----
    pattern: Tuple[str, ...] = ('global',)
    window: int = 0                 # sliding window width for 'local' layers
    # ---- position encoding ----
    pos: str = 'rope'               # 'rope' | 'learned' | 'sincos' | 'none'
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0   # 0 -> same theta for local layers
    max_seq_len: int = 131072
    # ---- extras ----
    qk_norm: bool = False
    embed_scale: bool = False       # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    num_meta_tokens: int = 0        # hymba learnable prefix tokens
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    dtype: str = 'bfloat16'
    # ---- the paper's feature ----
    precompute_supported: bool = True   # False only where PE blocks it (whisper)

    # ---------------------------------------------------------------- derived
    @property
    def q_size(self) -> int:
        if self.mla is not None:
            return self.num_heads * (self.mla.qk_nope_dim + self.mla.qk_rope_dim)
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        """'e' in the paper: output width of each of K and V."""
        if self.mla is not None:
            # the compressed latent replaces K and V jointly
            return self.mla.kv_lora_rank
        return self.num_kv_heads * self.head_dim

    @property
    def attn_out_size(self) -> int:
        if self.mla is not None:
            return self.num_heads * self.mla.v_head_dim
        return self.num_heads * self.head_dim

    @property
    def precompute_row_width(self) -> int:
        """Width of one precomputed-table row (paper: 2(d+e) when q_size==d).

        serial : [x, q, k, v]              -> d + q + e + e
        parallel: [s=x+FFN(LN(x)), q, k, v] -> d + q + e + e   (same width!)
        MLA    : [x, q, c_kv, k_pe]        -> d + q + r_kv + d_rope
        """
        if self.mla is not None:
            return (self.d_model + self.q_size + self.mla.kv_lora_rank
                    + self.mla.qk_rope_dim)
        return self.d_model + self.q_size + 2 * self.kv_size

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, pattern tiled to num_layers."""
        reps = math.ceil(self.num_layers / len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]

    @property
    def num_pattern_reps(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def num_tail_layers(self) -> int:
        return self.num_layers - self.num_pattern_reps * len(self.pattern)

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def layer_window(self, kind: str) -> int:
        """Effective attention window for a layer kind (0 = full causal)."""
        return self.window if kind in ('local', 'hybrid') else 0

    def layer_rope_theta(self, kind: str) -> float:
        if kind == 'local' and self.rope_theta_local:
            return self.rope_theta_local
        return self.rope_theta

    def validate(self) -> None:
        assert self.block_type in ('serial', 'parallel'), self.block_type
        assert self.pos in ('rope', 'learned', 'sincos', 'none'), self.pos
        for k in self.pattern:
            assert k in ('global', 'local', 'mlstm', 'slstm', 'hybrid',
                         'hybrid_global'), k
        if 'local' in self.pattern:
            assert self.window > 0, 'local layers need a window'
        if self.precompute_supported:
            # the paper's enabling condition: no PE between embedding and QKV
            assert self.pos in ('rope', 'none'), (
                f'{self.name}: precompute requires RoPE/no-PE, got {self.pos}')


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    'train_4k': InputShape('train_4k', 4096, 256, 'train'),
    'prefill_32k': InputShape('prefill_32k', 32768, 32, 'prefill'),
    'decode_32k': InputShape('decode_32k', 32768, 128, 'decode'),
    'long_500k': InputShape('long_500k', 524288, 1, 'decode'),
}
