"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device   — requires a CUDA device; prints the card's name and power
              limit as nvidia-smi reports them.
2. build    — compiles the CUDA kernels of the serving paths and the
              full-sequence forward from src/repro_torch/csrc (one nvcc per
              source, in parallel): embed_gather, gather_rope,
              paged_attention (dense, MLA and int8 forms), fused_page_write,
              cow_page_copy, rmsnorm_matmul, flash_attention.
3. kernels  — holds each kernel against its plain PyTorch version on the
              card, in bf16 and fp32, and times kernel, plain version, one
              PyTorch library call where one computes the same function,
              and the roofline bound: embed_gather (bitwise; N 1-4096 at
              mistral-7b and glm4-9b width, N 1-2048 at pythia-6.9b's 16384)
              and gather_rope (both also with
              the ids -1, -V, -V - 1, V, V + 7: wrapped rows and NaN rows,
              bitwise the plain versions, NaN equal to NaN; gather_rope at N
              1, 4, 64 and 512 for the mistral-7b, glm4-9b,
              deepseek-v2-lite-16b and pythia-6.9b rows (64 rotated heads
              of 128), one device kernel a call after the first, the nodes
              of a CUDA graph of the call), paged_attention at mistral-7b
              full-width shapes; paged_attention
              at glm4-9b's G 16 through a scattered page table (in bf16 the
              split kernel, also held to the flash check's row-scaled limit,
              and row t of each 16-token call bitwise a one-token call at pos0
              + t), and at pythia-6.9b's G 1 (32 kv heads, one query row a
              (slot, kv head) at T 1) in bf16; fused_page_write (bitwise;
              linear and ring jobs, modes 0/1/2, page-0 collisions, the int32
              position leaf) and cow_page_copy (bitwise; rem 0/7/16 over a
              body leaf flattened over 39 layers) at glm4-9b page shapes,
              each timed beside one launch of an empty kernel (the launch
              floor), and cow_page_copy at pythia-6.9b's 128 KB leaf pages
              over 31 layers, bf16 k/v/pos and the five int8 leaves
              (bitwise; rem 7 timed with the same pages every replay and
              with pages new to the L2); the MLA form of
              paged_attention at deepseek-v2-lite-16b shapes (fp32 queries over
              bf16 latent pages on the split kernel, row t of the 16-token
              call bitwise a one-token call, and over fp32 pages on the
              template kernel; T 1 and 16), gather_rope over its 17
              MLA segments (width 5696), and fused_page_write / cow_page_copy
              on its ckv / kpe / pos leaves over 27 layers (bitwise); the int8
              form of paged_attention (paged_attention_quant) at mistral-7b
              shapes on identity-table pages and at glm4-9b and pythia-6.9b
              (G 1) shapes through a scattered table (bf16 queries on the
              split kernel, also held to
              the row-scaled limit, row t of each 16-token call bitwise a
              one-token call; fp32 queries on the template kernel), and
              fused_page_write / cow_page_copy on the five
              int8 leaves (k, v int8; k_scale, v_scale bf16 of 4-byte rows;
              pos) at glm4-9b page shapes (bitwise); the quantizing form of
              fused_page_write (bf16 and fp32 K/V in, quantized in the
              write's launch) bitwise the eager quantizer + the plain write
              at glm4-9b's pool, T 1 and 16 and a ring, and with rows of NaN,
              zeros, .5 ties, bf16's largest values and an amax at which
              division and reciprocal differ at page sizes 1 and 16, timed at
              T 1 and 16 beside the launch floor, the eager quantizer, and
              the eager quantizer + the write of the quantized leaves;
              flash_attention at the
              shapes of the Model.apply phases (mistral-7b S 8192, 32 heads
              over 8 kv heads, window 4096; glm4-9b S 4096 over 2 kv heads,
              causal) and at a ragged S 4097, bf16 and fp32;
              sharded_paged_attention (paged_attention split over the kv heads
              of a serving mesh: card 0 repeated, or distinct GPUs where the
              machine has enough) at glm4-9b shapes (H 2, scattered table, T 1
              and 16) and mistral-7b shapes (H 2, 4, 8, window 4096, identity-
              table pages), bf16 and int8: bitwise the unsharded kernel, H
              launches, within KERNEL_TOL of its plain version, timed against
              the unsharded call on card 0 repeated (CUDA-graph replays, as
              every kernel time); at the paged mistral-7b engine's ring
              shapes (Sc 4111, 257 ring pages a slot scattered over its
              4485-page pool, 4 slots, window 4096): paged_attention and
              paged_attention_quant (bf16 q) at T 1 and 16 through the ring
              table, fused_page_write (bf16 and quantizing) with ring job
              lists at T 1, T 16 and T 16 with all 4 x 257 ring pages
              pending, each with its bound, plain version, library call and
              the launch floor. gemma3: the split paged_attention
              at gemma3-1b's d 256 (KV 1, G 4: four warps share a tile of
              query rows), dense and int8 forms, T 1 and 16, a local
              layer's ring (Sc 527, window 512) and a global layer's
              linear pages through a scattered table (bf16 within 2e-2
              and the row-scaled limit, int8 within KERNEL_TOL + one bf16
              step, T 16 rows bitwise one-token calls), with sdpa (bf16)
              and the bound; flash_attention at d 256 (S 4096, H 4, KV 1,
              window 512 and causal, bf16 and fp32); gather_rope at both
              gemma3 row widths (256-wide heads for gemma3-1b, layer 0's
              theta 10k) and embed_gather at them; the quantizing
              fused_page_write at KV 1, d 256 (linear and ring job lists,
              edge rows) and cow_page_copy over gemma3-1b's 25 stacked
              layers, bitwise.
4. mistral  — serves mistral-7b at full width and 16 of its 32 layers
              (DEPTHS: phases 4-7 and 10 cut depth, and only depth, to
              keep the script near 10 minutes; random bf16 weights from
              a seed, precomputed table, chunk 16, fused gather→RoPE, the
              cuda attention backend) on dense ring caches: 4 requests,
              prompts of 64-200 tokens, 16 new tokens each; then the same
              requests on the same weights without the table (the
              baseline) and with int8 KV caches (kv_quant=True), every
              attend through paged_attention_quant. On the same weights:
              the paper's layer-0 comparison (embedding rows +
              rmsnorm_matmul, and F.rms_norm + torch.matmul, against
              embed_gather of table rows; rmsnorm_matmul, in the form its
              shape takes (split-K up to N 8, wgmma above), held against its
              plain version within RMS_TOL and the row-scaled RMS_ROW_TOL,
              and timed beside the single-pass and the same-precision
              library calls) at N 1, 4, 64, 4096, 8192, and Model.apply at
              B 1, S 8192, baseline and precomputed: ms per forward, launch
              counts, logits of the two against each other and against the
              engine's chunked decode of the same prompt. Between the two,
              on the same weights and table, mistral-7b through the paged
              pool and the radix cache (ring pages with snapshots: page 16,
              max_seq 4608, chunk 16, Sc 4111, 257 ring pages a slot, the
              default 4485-page pool), a two-turn chat: 4 prompts of
              4160-4400 tokens, then each with its 16 tokens and 32 new
              ones (a prefix hit at its snapshot and a restore), 16 new
              tokens each; bf16, then an int8 pool: TTFT on a miss and on
              a hit, snapshot count and bytes, the device ms of a capture
              and of a restore, cow_page_copy never launched; after the
              bf16 run the chat again with the async double-buffered loop
              (async_loop=True): the bf16 run's greedy tokens, and the
              flushes at snapshot boundaries counted.
5. glm4     — serves glm4-9b at full width (20 of 40 layers) through
              the paged KV pool and the radix prefix cache (bf16, seeded
              random weights, precomputed table, page 16, max_seq 2048,
              chunk 16, fused gather→RoPE, cuda backend, 4 slots): two
              waves of 4 requests sharing a 256-token system prompt, one
              of which stops short
              inside a cached page (copy-on-write); prints tok/s, TTFT with
              and without a prefix hit, the device idle share and peak
              memory; then the same waves four times in turns without and
              with telemetry (off, on, on, off: greedy tokens bitwise,
              launches equal, every phase observed once a step; the host
              ms of the five step phases by step kind, and ms/step with
              telemetry on and off) and under a
              fault script with telemetry (a page steal that leaves 16
              pages and forces preemptions, its restore, a cancel
              mid-prefill, a poisoned lane: CANCELLED, FAILED
              ('nonfinite_logits'), every other request FINISHED with the
              unfaulted greedy tokens; no page leaked; the Chrome trace
              parsed from a file, one track per request); then the same
              two waves on the same weights through
              an int8 pool (kv_quant=True); then both runs again under a
              2x2 serving mesh (mesh='2x2': pool 2 x heads 2 over card 0
              repeated, 1536 pages so that the pool axis divides): greedy
              tokens bitwise the unsharded runs', paged_attention (or its
              int8 form) launched once per kv-head shard, the maintenance
              kernels as often as unsharded, the state at rest in its
              blocks, and, from the profiler trace, the device time of the
              copies that the gather (_rep_in) and the split (_shard_out)
              launch; the int8 runs' device "other" and device kernels a
              step beside bf16's; on every paged run no call of the eager
              quantizer and fused_page_write once a layer and a step; then
              the layer-0 comparison (N 1, 4, 64, 4096) and Model.apply at
              B 1, S 4096 as in phase 4. Between the first run and the
              telemetry turns, the two waves on fresh engines with
              segment-packed prefill, the async loop and both (sync,
              packed, async, both) and once more async with telemetry: greedy
              tokens equal to the synchronous unpacked run's, score() logits
              bitwise or their largest difference; ms/step, the programs'
              device span and idle share, prefill_lane_utilization and lanes
              dispatched, captures and replays, launches a step, and the
              overlap fraction (overlap_s over the host's schedule, radix and
              staging seconds).
6. deepseek — serves deepseek-v2-lite-16b (MLA + MoE) at full width and
              14 of 27 layers as phase 5 serves glm4-9b: paged pool, prefix
              cache, the MLA kernel on every attend; also logs the MoE drop
              count; then the waves unpacked and with segment-packed prefill on
              fresh engines: greedy tokens and MoE drops equal.
7. pythia  — serves pythia-6.9b (the paper's parallel block: LayerNorm, MHA, a
              GELU MLP; the table's rows [s, q, k, v] carry layer 0's FFN and
              skip too) at full width and 16 of 32 layers on seeded random bf16
              weights: dense caches with the table and the fused gather-RoPE, 4
              requests of 64-200 tokens + 16 new, then the same requests
              without the table (the share of equal greedy tokens printed); the
              paged pool with the radix cache (phase 5's two waves, a
              copy-on-write at 128 KB leaf pages); the layer-0 comparison
              (embedding rows + LN1 + Q/K/V + LN2 + FFN + skip against
              embed_gather of table rows, N 1, 4, 64, 2048) and Model.apply at
              B 1, S 2048, baseline and with the table. Launches: one gather a
              step, paged_attention once a layer and step, fused_page_write
              once a layer and step on the paged run, cow_page_copy once per
              cache and copy, flash_attention once a layer a forward,
              rmsnorm_matmul never.
8. pressure — the glm4-9b and mistral-7b (ring pages with snapshots)
              smoke configs in fp32 without the fused gather (so
              embed_gather runs on the paged path) and a pool too small
              for the slots: preemptions happen, tokens equal an
              unpressured run's.
9. consistency — on the card, fp32 smoke configs, with fp32 and then
              int8 KV caches: mistral-7b's cuda and reference backends
              give equal greedy tokens; glm4-9b and deepseek-v2-lite-16b
              paged with the cuda backend give dense reference's tokens
              through a copy-on-write and preemptions, and mistral-7b paged
              (ring pages) through ring wraps, snapshot hits and
              preemptions; pool contents after
              the kernel write path (fused_page_write, deferred clears,
              cow_page_copy) equal those after the plain scatters with
              eager clears, bit for bit, on every leaf (five with int8);
              deepseek's tokens are the same with kv_quant=True (its latent
              caches ignore it); glm4-9b under 2x2 and 1x2 meshes and
              deepseek under 2x2 (MLA attends unsharded) give the dense
              reference's tokens through the copy-on-write and the
              preemptions; with fp32 caches the paged cuda engines with
              segment-packed prefill and the async loop give them too,
              on 16 pages also under a page steal and on 12 through the
              preemptions.
10. gemma3  — serves gemma3-27b (20 of its 62 layers: layer 0, 3 x the 5:1
              local/global pattern and a tail of 1, depth the only cut; window
              1024; KV 16 x 128) and then gemma3-1b (26 layers, window 512, KV
              1 x 256) at full width and depth on seeded random bf16 weights:
              the table (qk_norm and the sqrt(d) embedding scale folded in),
              fused gather-RoPE at layer 0's theta (10k), the cuda backend, 4
              slots, chunk 16, page 16, max_seq 2048; a paged pool with ring
              pages for the local layers and linear pages for the global ones,
              the radix cache and snapshots (gemma3-27b's pool cut to 768
              pages, printed). Traffic: two waves of 4 requests on a 256-token
              system prompt (wave 1 puts a snapshot at its end, each request of
              wave 2 hits it; a hit under snapshots ends on a page boundary, so
              no copy-on-write), then a two-turn chat of 4 prompts of 1100-1300
              tokens whose second turns hit the snapshots. bf16 first inside
              _eager_steps(), then replayed and held bitwise against it, then
              int8 (and, for gemma3-27b, the async loop: the bf16 run's
              tokens); every attend on the split kernel and the template kernel
              never; then qk_norm's device ms a layer and a step at the step
              shapes, the layer-0 comparison (the embedding rows x sqrt(d),
              rmsnorm_matmul and qk_norm against embed_gather of table rows, N
              1, 4, 64, 4096) and Model.apply at B 1, S 4096, baseline and with
              the table (gemma3-1b: flash_attention at d 256 once a layer).
11. encoders — whisper-tiny-rope (the paper's 4-layer example: a
              bidirectional encoder over 1500 frames, a decoder with
              cross-attention, RoPE; the table folds layer 0's self Q/K/V)
              and whisper-tiny (learned positions: build_table refuses, the
              reason printed), then internvl2-1b (a VLM: 14 query heads
              over 2 kv heads of 64, G 7; the hybrid table), at full width
              and depth on seeded random bf16 weights, frames and patches
              from a seeded torch.Generator. whisper, following
              examples/whisper_decode.py: encoder_apply over 4 x 1500
              frames, prefill_cross_cache, 64 greedy decode steps from BOS
              without the table and with it (fed the baseline's tokens:
              logits within APPLY_TOL, argmax equal where the margin
              decides; its own greedy tokens equal), one embed_gather a
              step and no other launch (the attend is the reference, as
              'auto' resolves for audio); the decode step's device ms at
              B 1 and 4, baseline and with the table in turns, as CUDA-
              graph replays of Model.decode_step, beside the bound of the bytes
              a step reads; encdec_apply at B 1, decoder S 448, 4 runs of
              each in turns; the engine serving 4 requests (reference
              backend, chunk 1, dense caches, zero cross K/V) with tok/s.
              internvl2-1b as phase 5 serves glm4-9b: the paged pool, two
              waves on a 256-token system prompt, the table with the fused
              gather-RoPE, the cuda backend, bf16 and int8, each replayed
              run bitwise its eager twin; the layer-0 comparison (N 1-4096,
              rmsnorm_matmul at W 1152 over d 896), Model.apply at B 1, S
              4096 (16 text + 256 patches + 3824 text), baseline and with
              the hybrid table, and layer 0 alone over that sequence,
              baseline against hybrid. Phase 3 holds the kernels at these
              shapes: the split paged_attention (dense and int8) at d 64,
              G 7, T 1 and 16; flash_attention at d 64, H 14, KV 2, S
              4096; embed_gather at 1536 and 2048 wide rows; gather_rope
              over 14 + 2 heads of 64.
12. big   — mixtral-8x7b and mixtral-8x7b-parallel (the paper's §3
              third column: layer 0's whole MoE FFN in the table) at 8 of
              their 32 layers, llama3-405b at 4 of its 126, full width, on
              seeded random bf16 weights (depth the only cut): the table
              (the parallel Mixtral's build also reports the MoE token
              slots it drops) and core.analysis's read ratio at batch 1;
              the paged engine with the table and the fused gather-RoPE
              (llama3: 136 rotated heads), bf16, as an eager twin, then
              replayed and held bitwise against it, then without the table
              (token share reported): the Mixtrals on ring pages with
              phase 4's two-turn chat, llama3 on linear pages with phase
              5's two waves (a copy-on-write); MoE drops of every run;
              layer 0 alone (N 1, 4, 64, 4096) against the gather beside
              the analysis ratio (the parallel Mixtral's baseline runs LN2
              and the whole MoE); Model.apply at B 1, S 4096, baseline and
              with the table in turns. Phase 3 holds the kernels at
              llama3's shapes: gather_rope over 128 q + 8 k heads at theta
              500k (bitwise) and embed_gather on 34816-wide rows, N 1, 4,
              64, 512; flash_attention at H 128, KV 8, S 4096;
              rmsnorm_matmul at d 16384, W 18432 in the layer-0
              comparison. Phase 6 adds deepseek-v2-lite-16b's Model.apply
              at S 4096 (mla_full and the MoE aux loss: torch ops, no
              flash or rmsnorm_matmul launch).
13. recurrent — xlstm-125m (12 layers alternating mLSTM / sLSTM, d 768,
              no positions) and hymba-1.5b (32 hybrid layers: attention
              beside mamba heads, window 1024 but for layers 0 and 16,
              128 meta tokens) at full width and depth on seeded random
              bf16 weights; 4 slots, chunk 16, the cuda backend (the fused
              gather asked for falls back: layer 0 is no attention layer).
              Each prints its table, the analysis ratio at batch 1 and the
              engine runs' tok/s, ms/step, the step programs' device span
              and idle share, and the device kernels a step of each
              captured step shape. xlstm: the dense engine with the table
              over phase 4's traffic, first as an eager twin and then
              replayed on the same engine, bitwise (tokens, score logits,
              every state leaf); the traffic without the table; the paged
              engine with the radix cache over gemma_traffic's waves (wave
              2 hits 256 tokens on a snapshot of every recurrent and conv
              leaf's row; snapshot bytes printed; no page leaves), eager
              twin then a replayed engine, bitwise; the waves with
              segment-packed prefill and with the async loop (tokens equal
              to the replayed run's). hymba: prefix_cache=True refused
              with JAX's ValueError; each engine primes the meta tokens
              into every slot at construction (timed); a two-turn chat of
              4 prompts of 1100-1400 tokens, past the window, max_seq 2048:
              turn 1 as an eager twin, then on the same engine turn 1
              replayed bitwise and turn 2; one slot serving a 200-token
              prompt twice (the same tokens); the chat without the table.
              Launches: one embed_gather a step with the table, none
              without; paged_attention once per hymba layer and step;
              never a page kernel, gather_rope, rmsnorm_matmul or flash
              in an engine step. Then Model.apply at B 1, S 2048 (hymba +
              128 meta tokens) in turns, baseline and with the table
              (flash_attention once per hymba layer, none on xlstm; no
              rmsnorm_matmul: the hybrid block norms once for both
              branches as torch ops), and layer 0 alone (N 1-4096,
              LN1 and the block's projections as torch ops against
              embed_gather). Phase 3 holds embed_gather at their 5384-
              and 7040-wide rows (bitwise, N 1-4096), the split
              paged_attention at hymba's d 64, G 5 over dense caches as
              identity-table pages (a windowed layer's ring of 1039
              positions and a global layer's 2048, T 1 and 16) and
              flash_attention at H 25, KV 5, d 64, S 2176, causal and
              window 1024.

Every one-device engine run of phases 4-13 with the cuda backend steps
through the engine's per-step programs: each step shape's CUDA graph is
captured at its first step and replayed after (a mesh and the reference
backend run eagerly). Phases 4-7 run one engine of each family first
inside ``_eager_steps()`` (mistral-7b dense bf16 and int8, paged with
ring pages bf16; glm4-9b paged bf16 and int8; deepseek; pythia-6.9b
paged) and hold the replayed run's greedy tokens, ``score()`` logits and
caches or pool bitwise against it; each run prints its programs' capture
ms and replays and the graph pool's MiB, and each profile the device's
span of the programs' runs (CUDA events) and the device kernels of each
captured step shape (the nodes of a re-capture). Phase 5 also serves the
8 requests of the waves at once on a 64-slot glm4-9b engine (1537 pages):
every dispatch at bucket 8, tokens bitwise an 8-slot engine's.

In each engine phase the launch counters are zeroed just before the run
and read just after (a replay adds the launches its capture recorded);
every kernel of that path must have run (the int8 runs:
paged_attention_quant once per attention layer and step, the dense form
never; the baseline run: no gather; with the table one gather a step;
cow_page_copy once per cache and copy). Each Model.apply forward is
counted on its own: flash_attention once a layer, rmsnorm_matmul
(RMSNorm models) once a layer without the table and once less with it
(MLA: neither); MoE models return a positive finite aux loss, and their
logits agree with the other run's at MOE_AGREE of the positions at least
(a rounding-level routing tie moves a token's logits).
Ends with a ``{"kernels": [...]}`` line and, last, the device JSON line.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, 'src'))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_maintenance as PM  # noqa: E402
from repro_torch.kernels.embed_gather import (embed_gather,  # noqa: E402
                                              embed_gather_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.gather_rope import (gather_rope,  # noqa: E402
                                             gather_rope_plain)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    dense_as_pages, dense_identity_table, dense_page_split, mla_split_form,
    page_validity, paged_attention, paged_attention_mla, paged_attention_plain,
    paged_attention_quant, quant_split_form, sharded_paged_attention,
    sharded_paged_attention_plain, split_form)
from repro_torch.launch.mesh import (make_serving_mesh,  # noqa: E402
                                     parse_mesh_spec)
from repro_torch.kernels.rmsnorm_qkv import (  # noqa: E402
    EPS, rmsnorm_matmul, rmsnorm_matmul_form, rmsnorm_qkv, rmsnorm_qkv_plain)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.attention import (_quantize,  # noqa: E402
                                          paged_view)
from repro_torch.models.blocks import (block_preproj,  # noqa: E402
                                       preproj_layout)
from repro_torch.models.transformer import (  # noqa: E402
    fused_rope_segments, layer_plan)
from repro_torch.models.attn_backend import (KERNEL_TOL,  # noqa: E402
                                             ReferenceBackend)
from repro_torch.models.model import VLM_PREFIX, Model  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models.vlm import project_patches  # noqa: E402
from repro_torch.core.precompute import hybrid_vlm_pre0  # noqa: E402
from repro_torch.serving import telemetry as TM  # noqa: E402
from repro_torch.serving.engine import (Request, RequestStatus,  # noqa: E402
                                        ServingEngine, _eager_steps)
from repro_torch.serving.programs import COUNTED, StepProgram  # noqa: E402
from repro_torch.serving.faults import ScriptedFaults  # noqa: E402
from repro_torch.serving.kvpool import partition_pages  # noqa: E402
from repro_torch.sharding import ShardedLeaf, gather_leaf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
            torch.float32: 67e12}    # fp32 outside the tensor cores
KERNELS = COUNTED       # every kernel wrapper with a launch counter
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured once in a CUDA
    graph, replayed ``reps`` times between CUDA events — the host's launch
    cost is outside the measurement, so small kernels are not timed by the
    Python that launches them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes: float, ops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def free() -> None:
    """Return the last phase's tensors to the card before the next."""
    gc.collect()
    torch.cuda.empty_cache()


def zero_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# ----------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available()'
                         ' is False)')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f'[device] {smi}')
    log(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ----------------------------------------------------------------- phase 2
def phase_build() -> None:
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f'[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} '
        f'wall {time.perf_counter() - t0:.2f}s')
    for name in secs:
        ptx = (build.BUILD_DIR / f'{name}.log')
        if ptx.exists():
            for line in ptx.read_text().splitlines():
                if 'registers' in line or 'spill' in line:
                    log(f'[build] {name}: {line.strip()}')


# ----------------------------------------------------------------- phase 3
# (config, smoke?, dtypes, token counts) at which each gather kernel runs on
# an engine path of this script: mistral-7b, glm4-9b and pythia-6.9b
# (16384-wide rows, 64 rotated heads) at full width (chunk steps of 4 x 16
# tokens, decode steps of 4), the glm4-9b smoke config of the pressure phase
# (3 slots, chunk 8, fp32) and the smoke configs of the consistency phase;
# for embed_gather also N 1 and 4096 (2048 for pythia-6.9b), the decode and
# prefill sizes of the layer-0 comparison; gemma3-1b (2688-wide rows, 4 q
# heads and 1 k head of 256) and gemma3-27b (13568-wide rows, 48 rotated
# heads of 128) as their engines and layer-0 comparisons read them;
# whisper-tiny-rope (1536-wide rows: decode steps of 1 and 4 tokens, its
# engine's 4 slots, and Model.apply's 448 decoder positions) and
# internvl2-1b (2048-wide rows; gather_rope over 14 + 2 heads of 64);
# llama3-405b (34816-wide rows over its 128256-row vocabulary, 8.9 GB in
# bf16; gather_rope over 128 q + 8 k heads of 128 at theta 500k) at the
# token counts of its engine and layer-0 comparison (phase 12);
# xlstm-125m's [x, u1, u2, v, ifg] rows (5384 wide) and hymba-1.5b's
# [x, q, k, v, x_in, gate] rows (7040 wide) at the token counts of their
# engines, Model.apply and layer-0 comparisons (phase 13).
EMBED_CASES = (('mistral_7b', False, (torch.bfloat16, torch.float32),
                (1, 4, 64, 512, 4096)),
               ('glm4_9b', False, (torch.bfloat16, torch.float32),
                (1, 4, 64, 4096)),
               ('glm4_9b', True, (torch.float32,), (3, 24)),
               ('deepseek_v2_lite_16b', True, (torch.float32,), (3, 24)),
               ('pythia_6_9b', False, (torch.bfloat16,), (1, 4, 64, 2048)),
               ('gemma3_1b', False, (torch.bfloat16,), (1, 4, 64, 4096)),
               ('gemma3_27b', False, (torch.bfloat16,), (1, 4, 64, 4096)),
               ('whisper_tiny_rope', False, (torch.bfloat16,),
                (1, 4, 64, 448)),
               ('internvl2_1b', False, (torch.bfloat16,), (1, 4, 64, 4096)),
               ('llama3_405b', False, (torch.bfloat16,), (1, 4, 64, 512)),
               ('xlstm_125m', False, (torch.bfloat16,), (1, 4, 64, 4096)),
               ('hymba_1_5b', False, (torch.bfloat16,), (1, 4, 64, 4096)))
ROPE_CASES = (('mistral_7b', False, (torch.bfloat16, torch.float32),
               (1, 4, 64, 512)),
              ('glm4_9b', False, (torch.bfloat16, torch.float32),
               (1, 4, 64, 512)),
              ('deepseek_v2_lite_16b', False,
               (torch.bfloat16, torch.float32), (1, 4, 64, 512)),
              ('mistral_7b', True, (torch.float32,), (3, 12)),
              ('glm4_9b', True, (torch.float32,), (3, 24)),
              ('deepseek_v2_lite_16b', True, (torch.float32,), (3, 24)),
              ('pythia_6_9b', False, (torch.bfloat16,), (1, 4, 64, 512)),
              ('gemma3_1b', False, (torch.bfloat16, torch.float32),
               (1, 4, 64, 512)),
              ('gemma3_27b', False, (torch.bfloat16,), (1, 4, 64, 512)),
              ('internvl2_1b', False, (torch.bfloat16, torch.float32),
               (1, 4, 64, 512)),
              ('llama3_405b', False, (torch.bfloat16,), (1, 4, 64, 512)))
ROPE_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# rows held bitwise to the plain version (every row is reported): llama3's
# 136 rotated heads, past the 128 the kernel took before
ROPE_BITWISE = ('llama3_405b',)


def config_of(name: str, smoke: bool):
    return get_smoke_config(name) if smoke else get_config(name)


# the depth of an engine phase's model, where it is cut (full width; depth
# the only cut), so that the whole script ends in about 10 minutes on one
# H100: half the layers of the serving models of phases 4-7, and for
# gemma3-27b layer 0, three 5:1 local/global groups and the tail of 1 that
# its 62 layers end in (the same layer plan, 3 global layers); the
# Mixtrals' depth is BIG_MODELS'
DEPTHS = {'mistral_7b': 16, 'glm4_9b': 20, 'deepseek_v2_lite_16b': 14,
          'pythia_6_9b': 16, 'gemma3_27b': 20}


def cut_config(name: str):
    """``name``'s full-width config at its DEPTHS depth (or full depth);
    logs the cut."""
    full = get_config(name)
    depth = DEPTHS.get(name)
    if depth is None:
        return full
    log(f'[depth] {full.name}: {depth} of {full.num_layers} layers (full '
        'width; depth the only cut)')
    return dataclasses.replace(full, num_layers=depth)


def row_width(cfg) -> int:
    """Width of the config's table rows: the sum of its layer-0 layout
    (``blocks.preproj_layout``), which also covers the recurrent and
    hybrid rows."""
    plan = layer_plan(cfg)
    return sum(w for _, w in preproj_layout(cfg, plan.kinds[0],
                                            plan.use_moe[0]))


def out_of_range_ids(ids: torch.Tensor, V: int) -> torch.Tensor:
    """``ids`` after the ids -1, -V, -V - 1, V and V + 7: rows V - 1 and 0
    (wrapped, as ``jnp.take``), then three rows of NaN."""
    return torch.cat([torch.tensor([-1, -V, -V - 1, V, V + 7],
                                   dtype=torch.int32, device=ids.device),
                      ids])


def same_rows(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bitwise equal, a NaN equal to a NaN (whatever its bits)."""
    nan = got.isnan()
    if not torch.equal(nan, want.isnan()):
        return False
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


def check_out_of_range(name, got, want) -> None:
    """A gather of ``out_of_range_ids``: bitwise its plain version (NaN
    equal to NaN), rows 0-1 finite and rows 2-4 all NaN."""
    torch.cuda.synchronize()
    assert same_rows(got, want), f'{name}: ids out of range differ from ' \
        'the plain version'
    assert got[2:5].isnan().all() and not got[:2].isnan().any() \
        and not got[5:].isnan().any(), f'{name}: NaN rows misplaced'


def check_embed_gather(gen) -> dict:
    """embed_gather against its plain version, bitwise, at EMBED_CASES, also
    with the ids -1, -V, -V - 1, V and V + 7 in front (``jnp.take``: rows V
    - 1 and 0, then NaN rows; NaN equal to NaN). Times kernel, plain
    version, index_select and bound; the kernels line's row is mistral-7b
    bf16 N 4's, its ``at_n`` the full-width bf16 times."""
    row, at_n = {}, {}
    for name, smoke, dtypes, counts in EMBED_CASES:
        cfg = config_of(name, smoke)
        V, W = cfg.vocab_size, row_width(cfg)
        for dtype in dtypes:
            table = torch.randn((V, W), generator=gen,
                                device='cuda').to(dtype)
            for n in counts:
                ids = torch.randint(0, V, (n,), generator=gen, device='cuda',
                                    dtype=torch.int32)
                got = embed_gather(table, ids)
                want = embed_gather_plain(table, ids)
                torch.cuda.synchronize()
                assert torch.equal(got, want), \
                    f'embed_gather {cfg.name} {dtype} N={n}'
                bad = out_of_range_ids(ids, V)
                check_out_of_range(f'embed_gather {cfg.name} {dtype} N={n}',
                                   embed_gather(table, bad),
                                   embed_gather_plain(table, bad))
                id_sets = [torch.randint(0, V, (n,), generator=gen,
                                         device='cuda', dtype=torch.int32)
                           for _ in range(16)]
                calls = [0]

                def pick():
                    calls[0] += 1
                    return id_sets[calls[0] % 16]
                ms = time_ms(lambda: embed_gather(table, pick()))
                plain = time_ms(lambda: embed_gather_plain(table, pick()))
                lib = time_ms(lambda: torch.index_select(table, 0, pick()))
                b_ms, by = bound(2 * n * W * table.element_size() + 4 * n, 0,
                                 dtype)
                log(f'[kernel] embed_gather {cfg.name} {str(dtype)[6:]} '
                    f'N={n} V={V} W={W}: bitwise equal, also with ids -1, '
                    f'-V, -V - 1, V, V + 7 (rows V - 1, 0, NaN, NaN, NaN)'
                    f'; kernel {ms:.4f} ms, plain {plain:.4f} ms, '
                    f'index_select {lib:.4f} ms, bound {b_ms:.4f} ms ({by})')
                if not smoke and dtype is torch.bfloat16:
                    at_n.setdefault(cfg.name, {})[n] = dict(
                        ms=ms, library_ms=lib, bound_ms=b_ms)
                if (name, smoke, dtype, n) == ('mistral_7b', False,
                                               torch.bfloat16, 4):
                    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=by, library_ms=lib)
            del table
    return dict(row, at_n=at_n)


def rope_segments(cfg):
    """The segments the fused gather rotates in this config's table rows."""
    plan = layer_plan(cfg)
    return fused_rope_segments(
        preproj_layout(cfg, plan.kinds[0], plan.use_moe[0]), cfg)


def device_kernels(fn) -> int:
    """Device kernels (and copies) one call of ``fn`` runs: the nodes of a
    CUDA graph that captures the call, counted with ``cuGraphGetNodes``
    of ``libcuda``. The profiler's trace counts the same, but now and then
    delivers no device activity at all for the rest of a run."""
    import ctypes
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL('libcuda.so.1').cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc:
        raise RuntimeError(f'cuGraphGetNodes: CUDA error {rc}')
    return n.value


def fresh_rows_ms(table, V, n, kw, sets: int = 8) -> float:
    """gather_rope's device ms a call of ``n`` rows when the rows read and
    written are not in the L2 cache: ``time_ms`` replays the same ids, so
    at N 512 its reads and writes (21 MB at mistral-7b's width) stay in
    the H100's 50 MB L2. Here each call of a round takes its own ids and
    output, ``sets`` of them (168 MB a round at mistral-7b's width), so a
    call finds little of its rows in L2. The bound's bytes are the same."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    ids = [torch.randint(0, V, (n,), generator=gen, device='cuda',
                         dtype=torch.int32) for _ in range(sets)]
    pos = [torch.randint(0, 32768, (n,), generator=gen, device='cuda',
                         dtype=torch.int32) for _ in range(sets)]

    def round_():      # the outputs stay alive: a new address each call
        return [gather_rope(table, i, p, **kw) for i, p in zip(ids, pos)]
    return time_ms(round_, iters=4) / sets


def check_gather_rope(gen) -> dict:
    """gather_rope against its plain version at ROPE_CASES (within
    ROPE_TOL; unrotated columns, wrapped rows and NaN rows bitwise), one
    device kernel a call after the first (``device_kernels``), timed
    beside its plain version and bound; the kernels line's row is
    mistral-7b bf16 N 64's, its ``at_n`` the full-width bf16 times."""
    row, at_n = {}, {}
    for name, smoke, dtypes, counts in ROPE_CASES:
        cfg = config_of(name, smoke)
        V, W = cfg.vocab_size, cfg.precompute_row_width
        segs = rope_segments(cfg)
        rotated = torch.zeros(W, dtype=torch.bool, device='cuda')
        for off, heads, hd in segs:
            rotated[off:off + heads * hd] = True
        # layer 0's theta: 10k for gemma3's local layer 0
        kw = dict(segs=segs, theta=cfg.layer_rope_theta(
            layer_plan(cfg).kinds[0]))
        for dtype in dtypes:
            tol = ROPE_TOL[dtype]
            table = torch.randn((V, W), generator=gen,
                                device='cuda').to(dtype)
            for n in counts:
                ids = torch.randint(0, V, (n,), generator=gen, device='cuda',
                                    dtype=torch.int32)
                pos = torch.randint(0, 32768, (n,), generator=gen,
                                    device='cuda', dtype=torch.int32)
                pos[0] = 32767
                got = gather_rope(table, ids, pos, **kw)
                want = gather_rope_plain(table, ids, pos, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
                same = torch.equal(got, want)
                assert same or name not in ROPE_BITWISE, \
                    f'gather_rope {cfg.name} N={n}: not bitwise the plain ' \
                    f'version (max |err| {err:.3g})'
                assert torch.equal(got[:, ~rotated],
                                   table[ids.long()][:, ~rotated]), \
                    f'gather_rope {cfg.name} changed unrotated columns'
                bad = out_of_range_ids(ids, V)
                bad_pos = torch.cat([pos[:1].repeat(5), pos])
                check_out_of_range(
                    f'gather_rope {cfg.name} {dtype} N={n}',
                    gather_rope(table, bad, bad_pos, **kw),
                    gather_rope_plain(table, bad, bad_pos, **kw))
                n_dev = device_kernels(
                    lambda: gather_rope(table, ids, pos, **kw))
                assert n_dev == 1, f'gather_rope {cfg.name} N={n}: ' \
                    f'{n_dev} device kernels a call'
                ms = time_ms(lambda: gather_rope(table, ids, pos, **kw))
                plain = time_ms(
                    lambda: gather_rope_plain(table, ids, pos, **kw))
                b_ms, by = bound(2 * n * W * table.element_size() + 8 * n, 0,
                                 dtype)
                seg_txt = str(segs) if len(segs) <= 4 else \
                    f'{len(segs)} of width {segs[0][2]}'
                fresh = None
                if n == 512 and not smoke and dtype is torch.bfloat16:
                    fresh = fresh_rows_ms(table, V, n, kw)
                log(f'[kernel] gather_rope {cfg.name} {str(dtype)[6:]} N={n} '
                    f'segments {seg_txt} W={W} theta {kw["theta"]:g} max pos '
                    f'32767: max |err| {err:.3g} (tol {tol}'
                    + ('; bitwise required' if name in ROPE_BITWISE else '')
                    + f'), rows {"bitwise" if same else "not bitwise"} '
                    f'the plain version, untouched columns bitwise, ids '
                    f'-1, -V, -V - 1, V, V + 7 bitwise the plain version '
                    f'(NaN rows); one device kernel a call; '
                    f'kernel {ms:.4f} ms (same ids every replay'
                    + ('' if fresh is None else
                       f'; {fresh:.4f} ms with rows new to the L2 cache')
                    + f'), plain {plain:.4f} ms, bound {b_ms:.6f} ms ({by})')
                if not smoke and dtype is torch.bfloat16:
                    at_n.setdefault(cfg.name, {})[n] = dict(ms=ms,
                                                            bound_ms=b_ms)
                    if fresh is not None:
                        at_n[cfg.name][n]['fresh_rows_ms'] = fresh
                if (name, smoke, dtype, n) == ('mistral_7b', False,
                                               torch.bfloat16, 64):
                    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=by, library_ms=None)
            del table
    return dict(row, at_n=at_n)


def ring_case(gen, dtype, B, T, KV, G, d, Sc, lengths):
    """Dense ring caches of slots holding ``lengths`` tokens so far (ring
    wraparound past Sc, 0 = empty slot), viewed as identity-table pages,
    with queries for the last T positions of each slot."""
    k = torch.randn((B, Sc, KV, d), generator=gen, device='cuda').to(dtype)
    v = torch.randn((B, Sc, KV, d), generator=gen, device='cuda').to(dtype)
    cpos = torch.full((B, Sc), -1, dtype=torch.int32, device='cuda')
    for b, n in enumerate(lengths):
        p = torch.arange(max(0, n - Sc), n, device='cuda')
        cpos[b, p % Sc] = p.to(torch.int32)
    pos0 = torch.tensor([max(n - T, 0) for n in lengths], dtype=torch.int32,
                        device='cuda')
    q = torch.randn((B, T, KV, G, d), generator=gen, device='cuda').to(dtype)
    ps = dense_page_split(Sc)
    return (q, dense_as_pages(k, ps), dense_as_pages(v, ps),
            dense_as_pages(cpos, ps), dense_identity_table(B, Sc, ps, 'cuda'),
            pos0), (k, v, cpos)


def check_paged_bf16(label, got, want, args, kw,
                     fn=paged_attention) -> str:
    """The bf16 dense form (the split kernel) beyond 2e-2, and the int8
    form with bf16 q (``fn=paged_attention_quant``) beyond its elementwise
    limit: within the flash check's row-scaled limit (``FLASH_ROW_TOL``; at
    300-500 keys a row's RMS is ~0.05-0.07, so 2e-2 alone could pass a
    dropped key chunk), and, for a chunk of T > 1 queries, row t bitwise a
    one-token call at pos0 + t (``args`` are ``fn``'s, q first and pos0
    last). Returns the text of what held."""
    name = fn.__name__
    _, share = flash_error(got, want)
    if share > 1:
        raise AssertionError(f'{name} {label}: uses {share:.3f} of '
                             f'the row-scaled limit {FLASH_ROW_TOL}')
    q, pos0 = args[0], args[-1]
    T = q.shape[1]
    for t in range(T if T > 1 else 0):
        one = fn(q[:, t:t + 1].contiguous(), *args[1:-1], pos0 + t, **kw)
        if not torch.equal(one, got[:, t:t + 1]):
            raise AssertionError(f'{name} {label}: row {t} of the '
                                 f'T={T} call is not bitwise the one-token '
                                 'call at pos0 + t')
    return f'{share:.3f} of the row-scaled limit' + (
        f', rows bitwise {T} one-token calls' if T > 1 else '')


def check_paged_attention(gen) -> dict:
    cfg = get_config('mistral_7b')
    KV, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    B, Sc = 4, 512
    lengths = [700, 300, 0, 549]                  # wrap, partial, empty, wrap
    row = {}
    # bf16: the output's own rounding (2^-7 relative) on top of KERNEL_TOL
    for dtype, tol in ((torch.bfloat16, 2e-2),
                       (torch.float32, KERNEL_TOL['atol'])):
        for T in (1, 16):
            for window in (cfg.window, 300):
                args, (k, v, cpos) = ring_case(gen, dtype, B, T, KV, G, d, Sc,
                                               lengths)
                kw = dict(scale=d ** -0.5, window=window)
                got = paged_attention(*args, **kw)
                want = paged_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
                assert not got[2].any(), 'empty slot must attend to zeros'
                held = '' if dtype is not torch.bfloat16 else '; ' + \
                    check_paged_bf16(f'mistral T={T} window={window}', got,
                                     want, args, kw)
                ms = time_ms(lambda: paged_attention(*args, **kw))
                plain = time_ms(lambda: paged_attention_plain(*args, **kw))
                lib = library_attention_ms(args[0], k, v, cpos, args[5],
                                           window)
                b_ms, by = attention_bound(args[0], k, cpos, args[5], window,
                                           dtype)
                log(f'[kernel] paged_attention {str(dtype)[6:]} B={B} T={T} '
                    f'Sc={Sc} window={window}: max |err| {err:.3g} (tol '
                    f'{tol}{held}), empty slot zeros; kernel {ms:.4f} ms, '
                    f'plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound '
                    f'{b_ms:.4f} ms ({by})')
                if dtype is torch.bfloat16 and T == 1 \
                        and window == cfg.window:      # the decode step
                    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=by, library_ms=lib)
    return row


def attention_bound(q, k, cpos, pos0, window, dtype, scale_bytes=0):
    """Least time: the bytes of q, out, positions and the K/V rows some
    query may use (with ``scale_bytes`` more per row and kv head: the int8
    form's scales), and 4*d flops per usable (query row, key) pair."""
    B, T, KV, G, d = q.shape
    pos_t = pos0[:, None].long() + torch.arange(T, device='cuda')
    valid = page_validity(cpos, pos_t, window)               # (B, T, Sc)
    rows_used = int(valid.any(dim=1).sum())
    pairs = int(valid.sum()) * KV * G
    moved = 2 * nbytes(q) + nbytes(cpos, pos0) \
        + rows_used * KV * (2 * d * k.element_size() + scale_bytes)
    return bound(moved, 4 * d * pairs, dtype)


def library_attention_ms(q, k, v, cpos, pos0, window) -> float:
    """scaled_dot_product_attention on the (already gathered) dense view
    with a boolean mask — a yardstick only; the port never calls it."""
    B, T, KV, G, d = q.shape
    qh = q.reshape(B, T, KV * G, d).transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    pos_t = pos0[:, None].long() + torch.arange(T, device='cuda')
    mask = page_validity(cpos, pos_t, window)[:, None]       # (B,1,T,Sc)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=d ** -0.5))


# ------------------------------------------------- phase 3: glm4-9b pages
GLM_PS, GLM_SEQ, GLM_SLOTS = 16, 2048, 4


def glm_pool_pages() -> int:
    """The engine's default pool for glm4-9b at 4 slots, max_seq 2048."""
    lin = GLM_SEQ // GLM_PS
    return 1 + GLM_SLOTS * lin + 8 * lin


def page_leaves(gen, dtype, NP, ps, KV, d):
    k = torch.randn((NP, ps, KV, d), generator=gen, device='cuda').to(dtype)
    v = torch.randn((NP, ps, KV, d), generator=gen, device='cuda').to(dtype)
    pos = torch.randint(0, 4096, (NP, ps), generator=gen, device='cuda',
                        dtype=torch.int32)
    k[0], v[0], pos[0] = 0, 0, -1                # the null page
    return k, v, pos


def scattered_table(gen, B, P, NP, lengths, ps):
    """Page tables of slots holding ``lengths`` tokens, their pages drawn
    at random from [1, NP); blocks past a slot's length map to page 0."""
    perm = torch.randperm(NP - 1, generator=gen, device='cuda') + 1
    table = perm[:B * P].view(B, P).to(torch.int32).clone()
    for b, n in enumerate(lengths):
        table[b, -(-n // ps):] = 0
    return table


def write_counts(jobs, Sc, ps):
    """(rows written, rows filled) by a job list — this run's data."""
    j = jobs.long().cpu()
    r = torch.arange(ps)
    t = j[:, 2:3] + r[None]
    t = torch.where(t >= Sc, t - Sc, t)
    written = (t < j[:, 3:4]) & (j[:, 5:6] + r[None] < Sc)
    filled = (j[:, 4:5] >= PM.MODE_FRESH) & ~written
    return int(written.sum()), int(filled.sum())


def check_fused_page_write(gen, arch='glm4_9b',
                           dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """fused_page_write on ``arch``'s k / v / pos leaves (KV x d rows) over
    the engine's default pool of 4 slots, max_seq 2048, page 16, in each
    of ``dtypes``: linear job lists at T 1 and 16 and a ring of 27 at T
    16, with pending clears, bitwise the plain version; the bf16 linear
    writes timed. -> the bf16 decode step's (T 1) row."""
    cfg = get_config(arch)
    KV, d, ps, B = cfg.num_kv_heads, cfg.head_dim, GLM_PS, GLM_SLOTS
    NP = glm_pool_pages()
    row = {}
    cases = []
    # linear tables at the engine's geometry: slot 0 mid-prompt, slot 1
    # starting a fresh (pending) page, slot 2 inactive (all page 0), slot 3
    # decoding; two more pending pages are not written (clear jobs)
    P = GLM_SEQ // ps
    for T in (1, 16):
        lengths = [300 + T, 272 + T, 0, 365 + T]
        pos0 = torch.tensor([300, 272, 0, 365], dtype=torch.int32,
                            device='cuda')
        nv = torch.tensor([T, T, 0, 1], dtype=torch.int32, device='cuda')
        cases.append((f'linear T={T}', GLM_SEQ, T, pos0, nv,
                      scattered_table(gen, B, P, NP, lengths, ps)))
    # a ring of 27 entries: shorter than two pages, its last page partial,
    # the chunk wrapping past its end
    Sc, T = 27, 16
    P = -(-Sc // ps)
    pos0 = torch.tensor([20, 3, 0, 40], dtype=torch.int32, device='cuda')
    nv = torch.tensor([16, 9, 0, 16], dtype=torch.int32, device='cuda')
    cases.append((f'ring Sc={Sc} T={T}', Sc, T, pos0, nv,
                  scattered_table(gen, B, P, NP, [Sc] * B, ps)))
    for dtype in dtypes:
        k, v, pos = page_leaves(gen, dtype, NP, ps, KV, d)
        for label, Sc, T, pos0, nv, table in cases:
            start = torch.div(pos0 % Sc, ps, rounding_mode='floor').long()
            fresh = table[1, start[1]]
            pending = torch.stack([fresh, table.new_tensor(NP - 1),
                                   table.new_tensor(NP - 2),
                                   table.new_tensor(0)]).to(torch.int32)
            jobs = PM.build_jobs(pos0, nv, table, Sc, ps, T, pending)
            modes = set(jobs[:, 4].tolist())
            zero_jobs = int((jobs[:, 0] == 0).sum())
            assert modes == {0, 1, 2} and zero_jobs > 1, (modes, zero_jobs)
            vals = [torch.randn((B, T, KV, d), generator=gen,
                                device='cuda').to(dtype) for _ in range(2)]
            pos_t = PM.chunk_positions(pos0, T)
            leaves = [k, v, pos]
            srcs = [vals[0], vals[1], pos_t]
            fills = [0, 0, -1]
            want = [PM.fused_page_write_plain(x.clone(), s, jobs, Sc=Sc,
                                              fill=f)
                    for x, s, f in zip(leaves, srcs, fills)]
            PM.fused_page_write(leaves, srcs, jobs, Sc=Sc, fills=fills)
            torch.cuda.synchronize()
            for nm, g, w in zip(('k', 'v', 'pos'), leaves, want):
                assert torch.equal(g, w), f'fused_page_write {label} {nm}'
            assert torch.equal(pos[0], torch.full_like(pos[0], -1)) \
                and not k[0].any() and not v[0].any(), 'null page written'
            if not (label.startswith('linear') and dtype is torch.bfloat16):
                log(f'[kernel] fused_page_write {str(dtype)[6:]} {cfg.name} '
                    f'{label} (KV={KV} d={d}): bitwise equal (modes {sorted(modes)}, {zero_jobs} jobs '
                    'on page 0)')
                continue
            n_w, n_f = write_counts(jobs, Sc, ps)
            rb = [x[0, 0].numel() * x.element_size() for x in leaves]
            moved = n_w * 2 * sum(rb) + n_f * sum(rb) + nbytes(jobs)
            b_ms, by = bound(moved, 0, dtype)
            ms = time_ms(lambda: PM.fused_page_write(
                leaves, srcs, jobs, Sc=Sc, fills=fills))
            plain = time_ms(lambda: [PM.fused_page_write_plain(
                x, s, jobs, Sc=Sc, fill=f)
                for x, s, f in zip(leaves, srcs, fills)])
            # the same chunk rows by index_copy_ on each flattened leaf,
            # without the clears of the pending pages
            lib = library_page_write_ms(leaves, srcs, jobs, Sc, ps)
            log(f'[kernel] fused_page_write {str(dtype)[6:]} {cfg.name} '
                f'{label} NP={NP} KV={KV} d={d} ({jobs.shape[0]} jobs, {n_w} rows written, '
                f'{n_f} filled): bitwise equal (modes {sorted(modes)}, '
                f'{zero_jobs} jobs on page 0); kernel {ms:.4f} ms, plain '
                f'{plain:.4f} ms, index_copy_ x3 (no clears) {lib:.4f} ms, '
                f'bound {b_ms:.6f} ms ({by})')
            if label == 'linear T=1':                 # the decode step
                row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=lib)
        del k, v, pos
    return row


def library_page_write_ms(leaves, srcs, jobs, Sc, ps) -> float:
    j = jobs.long()
    r = torch.arange(ps, device='cuda')
    t = j[:, 2:3] + r[None]
    t = torch.where(t >= Sc, t - Sc, t)
    written = (t < j[:, 3:4]) & (j[:, 5:6] + r[None] < Sc)
    jw, rw = written.nonzero(as_tuple=True)
    dst = j[jw, 0] * ps + rw
    T = srcs[0].shape[1]
    lane = j[jw, 1] * T + t[jw, rw]
    flat = [x.view((-1,) + tuple(x.shape[2:])) for x in leaves]
    rows = [s.reshape((-1,) + tuple(s.shape[2:]))[lane] for s in srcs]
    return time_ms(lambda: [f.index_copy_(0, dst, s)
                            for f, s in zip(flat, rows)])


def check_cow_page_copy(gen) -> dict:
    """cow_page_copy at glm4-9b's pages (2 kv heads x 128: 8 KB a bf16 leaf
    page) over 39 stacked layers of the engine's pool, bf16 and fp32, then
    at pythia-6.9b's (``row['pythia']``)."""
    row = check_cow_pages(gen, 'glm4_9b', ('bf16', 'fp32'),
                          glm_pool_pages())['bf16']
    row['pythia'] = check_cow_pages(gen, 'pythia_6_9b', ('bf16', 'int8'),
                                    PYTHIA_COW_NP, fresh=True)
    return row


PYTHIA_COW_NP = 64          # pages a layer in the pythia-6.9b copy checks
COW_DTYPES = {'bf16': torch.bfloat16, 'fp32': torch.float32}


def cow_leaves(gen, arch, kind, NP):
    """``arch``'s pool leaves over its stacked layers (all but layer 0),
    ``NP`` pages a layer, flattened to (reps * NP, ps, ...) as
    ``cow_copy_cache`` passes them: k / v / pos in ``kind`` ('bf16' or
    'fp32'), or the five int8 leaves ('int8'). -> names, pools, fills,
    reps."""
    cfg = get_config(arch)
    KV, d, ps, reps = cfg.num_kv_heads, cfg.head_dim, GLM_PS, \
        cfg.num_layers - 1
    if kind == 'int8':
        names = QUANT_LEAVES
        pos = torch.randint(0, 4096, (reps * NP, ps), generator=gen,
                            device='cuda', dtype=torch.int32)
        pools = list(int8_leaves(gen, (reps * NP, ps), KV, d)) + [pos]
    else:
        names = ('k', 'v', 'pos')
        pools = list(page_leaves(gen, COW_DTYPES[kind], reps * NP, ps, KV,
                                 d))
    return names, pools, [PM.leaf_fill(nm) for nm in names], reps


def layer_jobs(reps, NP, src, dst, rem):
    """One copy-on-write job a stacked layer: page ``src`` into ``dst`` of
    each layer's ``NP`` pages, ``rem`` rows kept."""
    return torch.tensor([[src + r * NP, dst + r * NP, rem]
                         for r in range(reps)], dtype=torch.int32,
                        device='cuda')


def check_cow_pages(gen, arch, kinds, NP, fresh=False) -> dict:
    """cow_page_copy over ``arch``'s stacked leaves (``cow_leaves``), one
    job a layer, rem 0, 7 and 16, bitwise the plain version for each kind
    of ``kinds``; rem 7 timed with the same pages every replay (L2-warm)
    and, with ``fresh``, with pages new to the L2 (``fresh_cow_ms``).
    -> rows by kind."""
    cfg = get_config(arch)
    ps, out = GLM_PS, {}
    for kind in kinds:
        names, pools, fills, reps = cow_leaves(gen, arch, kind, NP)
        cache = {nm: x.view((reps, NP) + tuple(x.shape[1:]))
                 for nm, x in zip(names, pools)}
        what = f'cow_page_copy {cfg.name} {kind} ({"/".join(names)})'
        for src, dst, rem in ((11, 40, 0), (12, 41, 7), (13, 42, ps)):
            sdr = layer_jobs(reps, NP, src, dst, rem)
            want = [PM.cow_page_copy_plain(x.clone(), sdr, fill=f)
                    for x, f in zip(pools, fills)]
            PM.cow_copy_cache(cache, src, dst, rem, reps=reps)
            torch.cuda.synchronize()
            for nm, g, w in zip(names, pools, want):
                assert torch.equal(g, w), f'{what} rem={rem} {nm}'
            del want
            if rem != 7:
                log(f'[kernel] {what} rem={rem} over {reps} layers: bitwise '
                    f'equal')
                continue
            rb = [x[0, 0].numel() * x.element_size() for x in pools]
            moved = reps * sum((rem + ps) * b for b in rb) + nbytes(sdr)
            b_ms, by = bound(moved, 0, torch.bfloat16)
            ms = time_ms(lambda: PM.cow_page_copy(pools, sdr, fills=fills))
            new_ms = fresh_cow_ms(lambda jobs: PM.cow_page_copy(
                pools, jobs, fills=fills), reps, NP, rem) if fresh else None
            plain = time_ms(lambda: [PM.cow_page_copy_plain(x, sdr, fill=f)
                                     for x, f in zip(pools, fills)])
            lib = library_cow_copy_ms(pools, sdr, ps)
            fresh_text = '' if new_ms is None else \
                f', {new_ms:.4f} ms (pages new to the L2)'
            log(f'[kernel] {what} rem={rem} over {reps} layers '
                f'(KV={cfg.num_kv_heads}, NP={NP}, {moved} bytes): bitwise '
                f'equal; kernel {ms:.4f} ms (same pages every replay)'
                f'{fresh_text}, plain {plain:.4f} ms, indexed assignment '
                f'x{len(pools)} (no fills) {lib:.4f} ms, bound {b_ms:.4f} ms '
                f'({by})')
            out[kind] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=by, library_ms=lib)
            if fresh:
                out[kind]['fresh_ms'] = new_ms
        del cache, pools
        free()
    return out


def fresh_cow_ms(copy, reps, NP, rem, sets: int = 8) -> float:
    """Device ms a copy-on-write of ``reps`` stacked layers when its pages
    are not in the L2 cache: each call of a round copies its own pages
    (job set i: page 2i into page 2i + 1 on every layer), ``sets`` of
    them (about 94 MB a round at pythia-6.9b's bf16 pages, rem 7, against
    the H100's 50 MB L2). ``copy(sdr)`` launches one copy."""
    jobs = [layer_jobs(reps, NP, 2 * i, 2 * i + 1, rem)
            for i in range(1, sets + 1)]
    return time_ms(lambda: [copy(j) for j in jobs], iters=4) / sets


def library_cow_copy_ms(pools, sdr, ps) -> float:
    """The copies of the jobs' ``rem`` rows as one indexed assignment on
    each flattened leaf (``flat[dst rows] = flat[src rows]``), without the
    fills of the other rows — a yardstick only, as
    ``library_page_write_ms``."""
    j = sdr.long()
    r = torch.arange(ps, device='cuda')
    jw, rw = (r[None] < j[:, 2:3]).nonzero(as_tuple=True)
    src, dst = j[jw, 0] * ps + rw, j[jw, 1] * ps + rw
    flat = [x.view((-1,) + tuple(x.shape[2:])) for x in pools]

    def copy():
        for f in flat:
            f[dst] = f[src]
    return time_ms(copy)


def launch_floor_ms() -> float:
    """One launch of an empty kernel (``csrc/launch_floor.cu``, one block
    of 32 threads), timed as every kernel here: the floor under the
    smallest kernels' times."""
    lib = build.load('launch_floor')
    ms = time_ms(lambda: build.check(lib.launch_floor(
        torch.cuda.current_stream().cuda_stream), 'launch_floor'))
    log(f'[kernel] launch floor: an empty kernel (1 block of 32 threads) '
        f'{ms:.4f} ms a launch')
    return ms


GLM_LENGTHS = (300, 271, 0, 365)          # tokens held by the 4 slots


def scattered_pool(gen, dtype, arch='glm4_9b'):
    """``arch``'s K/V pages over glm4-9b's engine pool (glm4-9b: KV 2, d
    128; pythia-6.9b: KV 32) with slots of ``GLM_LENGTHS`` tokens through
    a scattered table: k, v, cpos, table."""
    cfg = get_config(arch)
    NP, ps = glm_pool_pages(), GLM_PS
    k, v, cpos = page_leaves(gen, dtype, NP, ps, cfg.num_kv_heads,
                             cfg.head_dim)
    table = scattered_table(gen, GLM_SLOTS, GLM_SEQ // ps, NP, GLM_LENGTHS,
                            ps)
    cpos.fill_(-1)
    for b, n in enumerate(GLM_LENGTHS):
        p = torch.arange(n, device='cuda')
        cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
    return k, v, cpos, table


def scattered_queries(gen, dtype, T, arch='glm4_9b'):
    """q (4, T, KV, G, d) of ``arch`` (glm4-9b: (4, T, 2, 16, 128);
    pythia-6.9b: (4, T, 32, 1, 128)) for the last T positions of each
    slot, pos0."""
    cfg = get_config(arch)
    KV = cfg.num_kv_heads
    pos0 = torch.tensor([max(n - T, 0) for n in GLM_LENGTHS],
                        dtype=torch.int32, device='cuda')
    q = torch.randn((GLM_SLOTS, T, KV, cfg.num_heads // KV, cfg.head_dim),
                    generator=gen, device='cuda').to(dtype)
    return q, pos0


def check_paged_attention_pools(gen) -> dict:
    """glm4-9b's KV 2, G 16, d 128 through a scattered table over the
    engine's pool: 16 query rows per (slot, kv head) at T 1, 256 at T 16;
    then pythia-6.9b's MHA (KV 32, G 1: one query row per (slot, kv head)
    at T 1, 16 at T 16) in bf16, its times under the row's ``pythia``."""
    row = check_paged_pool(gen, 'glm4_9b', (torch.bfloat16, torch.float32))
    row['pythia'] = check_paged_pool(gen, 'pythia_6_9b', (torch.bfloat16,),
                                     by_t=True)
    return row


def check_paged_pool(gen, arch, dtypes, by_t=False) -> dict:
    """``paged_attention`` over ``arch``'s scattered pool (``scattered_pool``),
    T 1 and 16, each dtype of ``dtypes``; bf16 held by
    ``check_paged_bf16`` and timed. -> the bf16 T 1 row, or with ``by_t``
    the bf16 rows by T."""
    cfg = get_config(arch)
    KV, d = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    B, NP = GLM_SLOTS, glm_pool_pages()
    tag = cfg.name.split('-')[0]
    row, rows_t = {}, {}
    tols = {torch.bfloat16: 2e-2, torch.float32: KERNEL_TOL['atol']}
    for dtype in dtypes:
        tol = tols[dtype]
        k, v, cpos, table = scattered_pool(gen, dtype, arch)
        for T in (1, 16):
            q, pos0 = scattered_queries(gen, dtype, T, arch)
            args = (q, k, v, cpos, table, pos0)
            kw = dict(scale=d ** -0.5, window=0)
            got = paged_attention(*args, **kw)
            want = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            assert not got[2].any(), 'empty slot must attend to zeros'
            view = paged_view({'k': k, 'v': v, 'pos': cpos}, table, GLM_SEQ)
            if dtype is not torch.bfloat16:
                log(f'[kernel] paged_attention {str(dtype)[6:]} {tag} G={G} '
                    f'T={T}: max |err| {err:.3g} (tol {tol})')
                continue
            held = check_paged_bf16(f'{tag} T={T}', got, want, args, kw)
            ms = time_ms(lambda: paged_attention(*args, **kw))
            plain = time_ms(lambda: paged_attention_plain(*args, **kw))
            lib = library_attention_ms(q, view['k'], view['v'], view['pos'],
                                       pos0, 0)
            b_ms, by = attention_bound(q, view['k'], view['pos'], pos0, 0,
                                       dtype)
            log(f'[kernel] paged_attention {str(dtype)[6:]} {tag} B={B} '
                f'KV={KV} G={G} T={T} ({T * G} rows per (slot, kv head)) '
                f'scattered table over NP={NP}: max |err| {err:.3g} (tol '
                f'{tol}; {held}), empty slot zeros; kernel {ms:.4f} ms, '
                f'plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} '
                f'ms ({by})')
            rows_t[T] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=by, library_ms=lib)
        del k, v, cpos
    return rows_t if by_t else rows_t[1]         # T 1: the decode step


# ------------------------------------ phase 3: deepseek-v2-lite-16b (MLA)
DS = 'deepseek_v2_lite_16b'


def mla_pool(gen, dtype, NP, ps, r, dr, lengths, P):
    """Latent pages of slots holding ``lengths`` tokens through a scattered
    table; the null page stays zero / -1."""
    ckv = torch.randn((NP, ps, r), generator=gen, device='cuda').to(dtype)
    kpe = torch.randn((NP, ps, dr), generator=gen, device='cuda').to(dtype)
    ckv[0], kpe[0] = 0, 0
    table = scattered_table(gen, len(lengths), P, NP, lengths, ps)
    cpos = torch.full((NP, ps), -1, dtype=torch.int32, device='cuda')
    for b, n in enumerate(lengths):
        p = torch.arange(n, device='cuda')
        cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
    return ckv, kpe, cpos, table


def check_paged_attention_mla(gen) -> dict:
    """The MLA form at deepseek-v2-lite-16b's widths (16 heads, latent 512
    + rope 64) through a scattered table over the engine's pool: fp32
    queries (W_UK absorbed in fp32) over bf16 pages (the engine's case:
    the split kernel; at T 16 row t bitwise the one-token call at pos0 +
    t), and all fp32 (the template kernel). Within KERNEL_TOL of the plain
    version, the empty slot zeros; prints which kernel ran, and beside
    ``mla_bound`` the bytes-only bound (the split kernel's scores run on the
    tensor cores, so the fp32 rate overstates its operations)."""
    cfg = get_config(DS)
    m = cfg.mla
    H, r, dr = cfg.num_heads, m.kv_lora_rank, m.qk_rope_dim
    B, ps, NP = GLM_SLOTS, GLM_PS, glm_pool_pages()
    P = GLM_SEQ // ps
    lengths = [300, 271, 0, 365]
    scale = (m.qk_nope_dim + dr) ** -0.5
    row = {}
    for page_dtype in (torch.bfloat16, torch.float32):
        ckv, kpe, cpos, table = mla_pool(gen, page_dtype, NP, ps, r, dr,
                                         lengths, P)
        pages = (ckv[:, :, None], kpe[:, :, None])
        for T in (1, 16):
            pos0 = torch.tensor([max(n - T, 0) for n in lengths],
                                dtype=torch.int32, device='cuda')
            q = torch.randn((B, T, 1, H, r + dr), generator=gen,
                            device='cuda')
            args = (q, pages[0], None, cpos, table, pos0)
            kw = dict(scale=scale, k2_pages=pages[1], mla_split=r)
            split = mla_split_form(q, *pages)
            got = paged_attention(*args, **kw)
            want = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            held = check_mla(got, want, args, kw)
            view = paged_view({'ckv': ckv, 'kpe': kpe, 'pos': cpos}, table,
                              GLM_SEQ)
            ms = time_ms(lambda: paged_attention(*args, **kw))
            plain = time_ms(lambda: paged_attention_plain(*args, **kw))
            lib = library_mla_ms(q, view, pos0, r, scale)
            b_ms, by = mla_bound(q, view, pos0, r)
            bytes_ms = mla_bound_bytes(q, view, pos0, r)
            log(f'[kernel] paged_attention_mla q float32 pages '
                f'{str(page_dtype)[6:]} B={B} T={T} H={H} r={r} dr={dr} '
                f'({T * H} rows per slot) scattered table over NP={NP}: '
                f'{"split" if split else "template"} kernel{held}; max '
                f'|err| {err:.3g} (tol {KERNEL_TOL["atol"]}), empty slot '
                f'zeros; kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa '
                f'{lib:.4f} ms, bound {b_ms:.4f} ms ({by}; bytes alone '
                f'{bytes_ms:.4f} ms)')
            if page_dtype is torch.bfloat16 and T == 1:   # the decode step
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=lib,
                           form='split' if split else 'template',
                           bytes_bound_ms=bytes_ms)
            if page_dtype is torch.bfloat16 and T == 16:
                row['at_t16'] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                     bound_ms=b_ms, library_ms=lib)
        del ckv, kpe, cpos, pages
    return row


def check_mla(got, want, args, kw) -> str:
    """The MLA form's checks: within KERNEL_TOL of the plain version, slot
    2 (empty) zeros, and on the split kernel at T > 1 row t bitwise the
    one-token call at pos0 + t. Returns the text of what held beyond
    KERNEL_TOL."""
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    assert not got[2].any(), 'empty slot must attend to zeros'
    q, pages, pos0 = args[0], args[1], args[5]
    T = q.shape[1]
    if T == 1 or not mla_split_form(q, pages, kw['k2_pages']):
        return ''
    for t in range(T):
        one = paged_attention(q[:, t:t + 1].contiguous(), *args[1:5],
                              pos0 + t, **kw)
        assert torch.equal(one, got[:, t:t + 1]), \
            f'paged_attention_mla: row {t} of the T={T} call is not ' \
            'bitwise the one-token call at pos0 + t'
    return f', rows bitwise {T} one-token calls'


def mla_bound(q, view, pos0, r):
    """Least time: q and out (fp32), the positions, and the latent rows
    some query may use read once; 2*(r + dr) + 2*r flops per usable
    (query row, key) pair at the fp32 rate (the scores are fp32)."""
    B, T, _, H, dq = q.shape
    pos_t = pos0[:, None].long() + torch.arange(T, device='cuda')
    valid = page_validity(view['pos'], pos_t, 0)             # (B, T, S)
    rows_used = int(valid.any(dim=1).sum())
    pairs = int(valid.sum()) * H
    es = view['ckv'].element_size()
    moved = nbytes(q) + B * T * H * r * 4 + nbytes(view['pos'], pos0) \
        + rows_used * dq * es
    return bound(moved, (2 * dq + 2 * r) * pairs, torch.float32)


def mla_bound_bytes(q, view, pos0, r) -> float:
    """``mla_bound``'s bytes alone: the least time of the split kernel,
    whose scores and value mix run on the tensor cores."""
    B, T, _, H, dq = q.shape
    pos_t = pos0[:, None].long() + torch.arange(T, device='cuda')
    valid = page_validity(view['pos'], pos_t, 0)
    moved = nbytes(q) + B * T * H * r * 4 + nbytes(view['pos'], pos0) \
        + int(valid.any(dim=1).sum()) * dq * view['ckv'].element_size()
    return bound(moved, 0, torch.float32)[0]


def library_mla_ms(q, view, pos0, r, scale) -> float:
    """scaled_dot_product_attention on the gathered latent view with keys
    [ckv | kpe] and values ckv, under an explicit mask, in q's dtype — a
    yardstick only; the port never calls it."""
    B, T, _, H, dq = q.shape
    k = torch.cat([view['ckv'], view['kpe']], dim=-1).to(q.dtype)
    kh = k[:, None].expand(B, H, k.shape[1], dq)
    vh = view['ckv'].to(q.dtype)[:, None].expand(B, H, k.shape[1], r)
    qh = q[:, :, 0].transpose(1, 2)                          # (B, H, T, dq)
    pos_t = pos0[:, None].long() + torch.arange(T, device='cuda')
    mask = page_validity(view['pos'], pos_t, 0)[:, None]     # (B,1,T,S)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale))


def check_mla_page_writes(gen) -> None:
    """fused_page_write and cow_page_copy on deepseek-v2-lite-16b's ckv
    (1024-byte bf16 rows), kpe (128-byte rows) and pos leaves: the chunk
    values are slices of gathered 5696-wide table rows, as layer 0 writes
    them; copy-on-write over layer 0 and the 26 stacked layers. Bitwise
    against the plain versions."""
    cfg = get_config(DS)
    m = cfg.mla
    r, dr, W = m.kv_lora_rank, m.qk_rope_dim, cfg.precompute_row_width
    ps, B, NP = GLM_PS, GLM_SLOTS, glm_pool_pages()
    P = GLM_SEQ // ps
    reps = layer_plan(cfg).reps
    c0 = cfg.d_model + cfg.q_size                        # ckv's row offset
    for dtype in (torch.bfloat16, torch.float32):
        ckv, kpe, pos, _ = mla_pool(gen, dtype, NP, ps, r, dr, [0] * B, P)
        pos.random_(0, 4096, generator=gen)
        pos[0] = -1
        for T in (1, 16):
            lengths = [300 + T, 272 + T, 0, 365 + T]
            pos0 = torch.tensor([300, 272, 0, 365], dtype=torch.int32,
                                device='cuda')
            nv = torch.tensor([T, T, 0, 1], dtype=torch.int32, device='cuda')
            table = scattered_table(gen, B, P, NP, lengths, ps)
            start = torch.div(pos0, ps, rounding_mode='floor').long()
            pending = torch.stack([table[1, start[1]],
                                   table.new_tensor(NP - 1),
                                   table.new_tensor(0)]).to(torch.int32)
            jobs = PM.build_jobs(pos0, nv, table, GLM_SEQ, ps, T, pending)
            rows = torch.randn((B, T, W), generator=gen,
                               device='cuda').to(dtype)
            srcs = [rows[..., c0:c0 + r], rows[..., c0 + r:c0 + r + dr],
                    PM.chunk_positions(pos0, T)]
            leaves, fills = [ckv, kpe, pos], [0, 0, -1]
            want = [PM.fused_page_write_plain(x.clone(), v, jobs, Sc=GLM_SEQ,
                                              fill=f)
                    for x, v, f in zip(leaves, srcs, fills)]
            PM.fused_page_write(leaves, srcs, jobs, Sc=GLM_SEQ, fills=fills)
            torch.cuda.synchronize()
            for nm, g, w in zip(('ckv', 'kpe', 'pos'), leaves, want):
                assert torch.equal(g, w), f'fused_page_write mla T={T} {nm}'
            msg = (f'[kernel] fused_page_write {str(dtype)[6:]} deepseek '
                   f'ckv/kpe/pos (row bytes {r * ckv.element_size()}/'
                   f'{dr * kpe.element_size()}/{4 * 1}, values strided '
                   f'slices of {W}-wide rows) T={T}, {jobs.shape[0]} jobs: '
                   'bitwise equal')
            if dtype is torch.bfloat16:
                n_w, n_f = write_counts(jobs, GLM_SEQ, ps)
                rb = [x[0, 0].numel() * x.element_size() for x in leaves]
                b_ms, by = bound(n_w * 2 * sum(rb) + n_f * sum(rb)
                                 + nbytes(jobs), 0, dtype)
                ms = time_ms(lambda: PM.fused_page_write(
                    leaves, srcs, jobs, Sc=GLM_SEQ, fills=fills))
                plain = time_ms(lambda: [PM.fused_page_write_plain(
                    x, v, jobs, Sc=GLM_SEQ, fill=f)
                    for x, v, f in zip(leaves, srcs, fills)])
                msg += (f'; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound '
                        f'{b_ms:.6f} ms ({by})')
            log(msg)
        del ckv, kpe, pos
        # copy-on-write: layer 0's cache and the stacked body, one launch
        # each, as the engine's _cow_copy launches them
        lay0 = {'ckv': torch.randn((NP, ps, r), generator=gen,
                                   device='cuda').to(dtype),
                'kpe': torch.randn((NP, ps, dr), generator=gen,
                                   device='cuda').to(dtype),
                'pos': torch.randint(0, 4096, (NP, ps), generator=gen,
                                     device='cuda', dtype=torch.int32)}
        body = {nm: torch.stack([x] * reps) for nm, x in lay0.items()}
        for src, dst, rem in ((11, 900, 0), (12, 901, 7), (13, 902, ps)):
            want = {}
            for part, cache, n in (('layer0', lay0, 0), ('body', body, reps)):
                flat = {nm: x.clone().view((max(n, 1) * NP,)
                                           + tuple(x.shape[2 if n else 1:]))
                        for nm, x in cache.items()}
                sdr = torch.tensor([[src + i * NP, dst + i * NP, rem]
                                    for i in range(max(n, 1))],
                                   dtype=torch.int32, device='cuda')
                want[part] = {nm: PM.cow_page_copy_plain(
                    x, sdr, fill=PM.leaf_fill(nm)) for nm, x in flat.items()}
            n0 = PM.cow_page_copy.launches
            PM.cow_copy_cache(lay0, src, dst, rem)
            PM.cow_copy_cache(body, src, dst, rem, reps=reps)
            torch.cuda.synchronize()
            assert PM.cow_page_copy.launches == n0 + 2
            for part, cache in (('layer0', lay0), ('body', body)):
                for nm, x in cache.items():
                    assert torch.equal(x.reshape(want[part][nm].shape),
                                       want[part][nm]), \
                        f'cow_page_copy mla rem={rem} {part} {nm}'
        log(f'[kernel] cow_page_copy {str(dtype)[6:]} deepseek ckv/kpe/pos '
            f'over 1 + {reps} layers, rem 0/7/16: bitwise equal, 2 launches '
            'per copy-on-write')
        del lay0, body


# ----------------------------------------- phase 3: the int8 KV cache
def int8_leaves(gen, lead, KV, d):
    """int8 K/V and bf16 scales of leading shape ``lead``, as written by
    the model's quantizer: values in [-127, 127], scales of activations
    of magnitude ~1-10 (amax / 127)."""
    k = torch.randint(-127, 128, lead + (KV, d), generator=gen,
                      device='cuda', dtype=torch.int8)
    v = torch.randint(-127, 128, lead + (KV, d), generator=gen,
                      device='cuda', dtype=torch.int8)
    ks = (torch.rand(lead + (KV,), generator=gen, device='cuda') * 0.08
          + 0.005).to(torch.bfloat16)
    vs = (torch.rand(lead + (KV,), generator=gen, device='cuda') * 0.08
          + 0.005).to(torch.bfloat16)
    return k, v, ks, vs


def quant_plain(args, kw):
    """paged_attention_plain of a paged_attention_quant call's
    arguments."""
    q, k, v, ks, vs, cpos, table, pos0 = args
    return paged_attention_plain(q, k, v, cpos, table, pos0, **kw,
                                 k_scale_pages=ks, v_scale_pages=vs)


def check_quant(label, got, want, args, kw, empty: bool = True) -> tuple:
    """An int8 attend against its plain version: fp32 queries within
    KERNEL_TOL; bf16 queries within KERNEL_TOL on top of one bf16 step of
    the output (2^-7 of its magnitude: two fp32 sums that differ in their
    last bits may round to neighbouring bf16 values), then
    ``check_paged_bf16`` (the row-scaled limit, and a T 16 call's rows
    bitwise one-token calls); with ``empty``, slot 2 (an empty slot)
    zeros. Returns (max |err|, the text of what held)."""
    q = args[0]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    lim = KERNEL_TOL['atol'] + KERNEL_TOL['rtol'] * want.float().abs()
    if q.dtype is torch.bfloat16:
        lim = lim + want.float().abs() * 2.0 ** -7
    assert bool((diff <= lim).all()), f'paged_attention_quant {label}: ' \
        f'max |err| {err:.3g}'
    assert got.dtype == q.dtype and not (empty and got[2].any()), \
        'empty slot must attend to zeros'
    held = 'KERNEL_TOL'
    if q.dtype is torch.bfloat16:
        held += ' + one bf16 step; ' + check_paged_bf16(
            label, got, want, args, kw, fn=paged_attention_quant)
    return err, held


def check_quant_case(label, args, kw, view_pos, empty: bool = True
                     ) -> dict:
    """One int8 attend held by ``check_quant``, timed with the bound.
    ``view_pos`` is the slots' stored positions in dense order."""
    q, k, pos0 = args[0], args[1], args[-1]
    got = paged_attention_quant(*args, **kw)
    want = quant_plain(args, kw)
    torch.cuda.synchronize()
    err, held = check_quant(label, got, want, args, kw, empty)
    ms = time_ms(lambda: paged_attention_quant(*args, **kw))
    plain_ms = time_ms(lambda: quant_plain(args, kw))
    B, _, KV, G, d = q.shape
    # int8 K/V rows plus their two bf16 scales
    b_ms, by = attention_bound(q, k, view_pos, pos0, kw['window'], q.dtype,
                               scale_bytes=2 * 2)
    form = 'split' if quant_split_form(q, k) else 'template'
    log(f'[kernel] paged_attention_quant q {str(q.dtype)[6:]} {label} B={B} '
        f'KV={KV} G={G} d={d}: {form} kernel; max |err| {err:.3g} '
        f'({held})' + (', empty slot zeros' if empty else '') + f'; kernel '
        f'{ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, no library call reads int8 pages with scales, '
        f'bound {b_ms:.4f} ms ({by})')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)


def quant_cases(gen, dtypes):
    """(label, args, kwargs, stored positions in dense order) of the int8
    form at the shapes of both int8 engine phases: mistral-7b (KV 8, G 4)
    on dense rings of 512 viewed as identity-table pages, with its 4096
    window and a 300 one; glm4-9b (KV 2, G 16) and pythia-6.9b's MHA (KV
    32, G 1) through a scattered table over the engine's pool. T 1 and 16,
    queries of each of ``dtypes`` (the engines' bf16, the smoke configs'
    fp32)."""
    cfg = get_config('mistral_7b')
    KV, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    B, Sc = 4, 512
    lengths = [700, 300, 0, 549]                  # wrap, partial, empty, wrap
    k, v, ks, vs = int8_leaves(gen, (B, Sc), KV, d)
    cpos = torch.full((B, Sc), -1, dtype=torch.int32, device='cuda')
    for b, n in enumerate(lengths):
        p = torch.arange(max(0, n - Sc), n, device='cuda')
        cpos[b, p % Sc] = p.to(torch.int32)
    ps = dense_page_split(Sc)
    pages = [dense_as_pages(x, ps) for x in (k, v, ks, vs, cpos)]
    table = dense_identity_table(B, Sc, ps, 'cuda')
    for dtype in dtypes:
        for T in (1, 16):
            for window in (cfg.window, 300):
                pos0 = torch.tensor([max(n - T, 0) for n in lengths],
                                    dtype=torch.int32, device='cuda')
                q = torch.randn((B, T, KV, G, d), generator=gen,
                                device='cuda').to(dtype)
                yield (f'mistral Sc={Sc} window={window} T={T}',
                       (q, *pages, table, pos0),
                       dict(scale=d ** -0.5, window=window), cpos)
    del k, v, ks, vs, cpos, pages
    for arch in ('glm4_9b', 'pythia_6_9b'):
        cfg = get_config(arch)
        KV, d = cfg.num_kv_heads, cfg.head_dim
        G = cfg.num_heads // KV
        B, ps, NP = GLM_SLOTS, GLM_PS, glm_pool_pages()
        P = GLM_SEQ // ps
        lengths = [300, 271, 0, 365]
        k, v, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
        table = scattered_table(gen, B, P, NP, lengths, ps)
        cpos = torch.full((NP, ps), -1, dtype=torch.int32, device='cuda')
        for b, n in enumerate(lengths):
            p = torch.arange(n, device='cuda')
            cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
        view = paged_view({'pos': cpos}, table, GLM_SEQ)
        for dtype in dtypes:
            for T in (1, 16):
                pos0 = torch.tensor([max(n - T, 0) for n in lengths],
                                    dtype=torch.int32, device='cuda')
                q = torch.randn((B, T, KV, G, d), generator=gen,
                                device='cuda').to(dtype)
                yield (f'{cfg.name.split("-")[0]} scattered table over '
                       f'NP={NP} T={T}', (q, k, v, ks, vs, cpos, table, pos0),
                       dict(scale=d ** -0.5, window=0), view['pos'])
        del k, v, ks, vs, cpos


def check_paged_attention_quant(gen) -> dict:
    """Every case of ``quant_cases``, bf16 and fp32 queries, held and timed
    by ``check_quant_case``. Row: glm4 bf16 T 1 (the decode step); under
    ``pythia``, pythia-6.9b's bf16 rows by T."""
    row, pythia = {}, {}
    for label, args, kw, view_pos in quant_cases(
            gen, (torch.bfloat16, torch.float32)):
        r = check_quant_case(label, args, kw, view_pos)
        if args[0].dtype is not torch.bfloat16:
            continue
        if label.startswith('glm4') and args[0].shape[1] == 1:
            row = r
        if label.startswith('pythia'):
            pythia[args[0].shape[1]] = r
    return dict(row, pythia=pythia)


# ----------------------- phase 3: sharded_paged_attention over a mesh
def card0_mesh(spec):
    """The serving mesh ``spec`` over card 0 repeated: the mesh that every
    sharded time is taken on (a CUDA graph holds one device)."""
    p, h = parse_mesh_spec(spec)
    return make_serving_mesh(spec,
                             devices=[torch.device('cuda', 0)] * (p * h))


def card_mesh(spec: str):
    """The serving mesh ``spec`` over distinct GPUs where the machine has
    enough of them, else over card 0 repeated."""
    p, h = parse_mesh_spec(spec)
    if torch.cuda.device_count() < p * h:
        return card0_mesh(spec)
    return make_serving_mesh(spec)


def mesh_text(mesh) -> str:
    devs = [str(d) for row in mesh.devices for d in row]
    where = f'{devs[0]} repeated {len(devs)} times' if len(set(devs)) == 1 \
        else f'{len(set(devs))} distinct GPUs ({", ".join(devs)})'
    return f'mesh {mesh.shape[0]}x{mesh.shape[1]} over {where}'


def check_sharded_case(label, mesh, args, kw) -> dict:
    """One head-split call: bitwise the unsharded kernel's output, H shard
    launches, within KERNEL_TOL (plus one bf16 step of the output for bf16
    queries, as the int8 checks) of its plain version. Timed: the sharded
    call, the unsharded one, and one shard's launch on its own sliced
    inputs, all on card 0 (``card0_mesh``: the same call as on ``mesh``
    where the machine has one card); the sharded time less H shard launches
    is the split's copies and the join."""
    q = args[0]
    scales = kw.get('k_scale_pages'), kw.get('v_scale_pages')
    base = dict(scale=kw['scale'], window=kw['window'])

    def one():
        if scales[0] is not None:
            return paged_attention_quant(*args[:3], *scales, *args[3:],
                                         **base)
        return paged_attention(*args, **base)

    def sharded():
        return sharded_paged_attention(*args, mesh=mesh, **kw)

    def plain():
        return sharded_paged_attention_plain(*args, mesh=mesh, **kw)
    n0 = sharded_paged_attention.launches
    got = sharded()
    torch.cuda.synchronize()
    assert sharded_paged_attention.launches == n0 + mesh.shape[1], label
    assert torch.equal(got, one()), \
        f'sharded_paged_attention {label}: not bitwise the unsharded kernel'
    want = plain()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    lim = KERNEL_TOL['atol'] + KERNEL_TOL['rtol'] * want.float().abs()
    if q.dtype is torch.bfloat16:
        lim = lim + want.float().abs() * 2.0 ** -7
    assert bool((diff <= lim).all()), \
        f'sharded_paged_attention {label}: max |err| {err:.3g}'
    B, T, KV, G, d = q.shape
    H = mesh.shape[1]

    def head0(x, dim=2):
        return None if x is None else x.narrow(dim, 0, KV // H).contiguous()
    sq, sk, sv = head0(q), head0(args[1]), head0(args[2])
    s_scales = head0(scales[0]), head0(scales[1])

    def shard():
        if scales[0] is not None:
            return paged_attention_quant(sq, sk, sv, *s_scales, *args[3:],
                                         **base)
        return paged_attention(sq, sk, sv, *args[3:], **base)
    on0 = card0_mesh(mesh.shape)
    ms = time_ms(lambda: sharded_paged_attention(*args, mesh=on0, **kw))
    ms_one, ms_shard = time_ms(one), time_ms(shard)
    log(f'[kernel] sharded_paged_attention {label} q {str(q.dtype)[6:]} '
        f'B={B} T={T} KV={KV} G={G} H={H}: bitwise the unsharded '
        f'{"int8 " if scales[0] is not None else ""}kernel, {H} launches, '
        f'max |err| against its plain version {err:.3g}; sharded {ms:.4f} '
        f'ms = {H} shard launches of {ms_shard:.4f} ms + '
        f'{ms - H * ms_shard:.4f} ms of slicing copies and the join; '
        f'unsharded {ms_one:.4f} ms')
    return dict(max_abs_err=err, ms=ms, ms_unsharded=ms_one,
                ms_shard=ms_shard, plain=plain)


def check_sharded_paged_attention(gen) -> dict:
    """The head split at the shapes of the mesh phases: glm4-9b (KV 2, G
    16, d 128, H 2) through a scattered table over the engine's pool, T 1
    and 16, bf16 and int8 pages (bf16 queries); mistral-7b (KV 8, G 4, H
    2 / 4 / 8, window 4096) on dense rings of 512 viewed as identity-table
    pages, T 1 and 16, bf16 and int8. Row: glm4 bf16 T 1 (the decode step
    of the mesh phase), with the bound and library time of the unsharded
    kernel's row (the same work)."""
    cfg = get_config('glm4_9b')
    KV, d = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    B, ps, NP = GLM_SLOTS, GLM_PS, glm_pool_pages()
    P = GLM_SEQ // ps
    lengths = [300, 271, 0, 365]
    mesh = card_mesh('1x2')
    log(f'[kernel] sharded_paged_attention: {mesh_text(mesh)}')
    k, v, cpos = page_leaves(gen, torch.bfloat16, NP, ps, KV, d)
    table = scattered_table(gen, B, P, NP, lengths, ps)
    cpos.fill_(-1)
    for b, n in enumerate(lengths):
        p = torch.arange(n, device='cuda')
        cpos[table[b, p // ps].long(), p % ps] = p.to(torch.int32)
    k8, v8, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
    row = {}
    for T in (1, 16):
        pos0 = torch.tensor([max(n - T, 0) for n in lengths],
                            dtype=torch.int32, device='cuda')
        q = torch.randn((B, T, KV, G, d), generator=gen,
                        device='cuda').to(torch.bfloat16)
        kw = dict(scale=d ** -0.5, window=0)
        r = check_sharded_case(f'glm4 T={T} scattered table over NP={NP}',
                               mesh, (q, k, v, cpos, table, pos0), kw)
        check_sharded_case(f'glm4 int8 T={T}', mesh,
                           (q, k8, v8, cpos, table, pos0),
                           dict(kw, k_scale_pages=ks, v_scale_pages=vs))
        if T == 1:                                     # the decode step
            view = paged_view({'k': k, 'v': v, 'pos': cpos}, table, GLM_SEQ)
            plain = time_ms(r.pop('plain'))
            lib = library_attention_ms(q, view['k'], view['v'], view['pos'],
                                       pos0, 0)
            b_ms, by = attention_bound(q, view['k'], view['pos'], pos0, 0,
                                       torch.bfloat16)
            log(f'[kernel] sharded_paged_attention glm4 T=1: plain '
                f'{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms '
                f'({by})')
            row = dict(max_abs_err=r['max_abs_err'], ms=r['ms'],
                       plain_ms=plain, bound_ms=b_ms, bound_by=by,
                       library_ms=lib, ms_unsharded=r['ms_unsharded'],
                       ms_shard=r['ms_shard'])
    del k, v, cpos, k8, v8, ks, vs
    cfg = get_config('mistral_7b')
    KV, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    B, Sc = 4, 512
    lengths = [700, 300, 0, 549]                  # wrap, partial, empty, wrap
    k8, v8, ks, vs = (dense_as_pages(x, dense_page_split(Sc))
                      for x in int8_leaves(gen, (B, Sc), KV, d))
    for H in (2, 4, 8):
        mesh = card_mesh(f'1x{H}')
        for T in (1, 16):
            args, _ = ring_case(gen, torch.bfloat16, B, T, KV, G, d, Sc,
                                lengths)
            kw = dict(scale=d ** -0.5, window=cfg.window)
            check_sharded_case(f'mistral window={cfg.window}', mesh, args, kw)
            check_sharded_case(f'mistral int8 window={cfg.window}', mesh,
                               (args[0], k8, v8, *args[3:]),
                               dict(kw, k_scale_pages=ks, v_scale_pages=vs))
    return row


QUANT_LEAVES = ('k', 'v', 'k_scale', 'v_scale', 'pos')
QUANT_PAIRS = [(0, 2), (1, 3)]     # (k, k_scale), (v, v_scale)


def check_quant_page_writes(gen) -> dict:
    """fused_page_write and cow_page_copy on glm4-9b's five int8 leaves:
    k / v int8 (256-byte rows), k_scale / v_scale bf16 (4-byte rows: KV 2
    x 2 bytes), pos; the chunk values as the quantizer makes them, and
    then the quantizing form (float K/V in, quantized in the write's
    launch; :func:`check_quantizing_write`). Linear and ring job lists
    with pending clears; copy-on-write over the 39 stacked layers. Bitwise
    against the plain versions. -> the quantizing form's times."""
    cfg = get_config('glm4_9b')
    KV, d, ps, B = cfg.num_kv_heads, cfg.head_dim, GLM_PS, GLM_SLOTS
    NP = glm_pool_pages()
    names = QUANT_LEAVES
    fills = [PM.leaf_fill(nm) for nm in names]
    k, v, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
    pos = torch.randint(0, 4096, (NP, ps), generator=gen, device='cuda',
                        dtype=torch.int32)
    leaves = [k, v, ks, vs, pos]
    for x, f in zip(leaves, fills):
        x[0] = f                                  # the null page
    P = GLM_SEQ // ps
    cases = []
    for T in (1, 16):
        pos0 = torch.tensor([300, 272, 0, 365], dtype=torch.int32,
                            device='cuda')
        nv = torch.tensor([T, T, 0, 1], dtype=torch.int32, device='cuda')
        cases.append((f'linear T={T}', GLM_SEQ, T, pos0, nv, scattered_table(
            gen, B, P, NP, [300 + T, 272 + T, 0, 365 + T], ps)))
    pos0 = torch.tensor([20, 3, 0, 40], dtype=torch.int32, device='cuda')
    nv = torch.tensor([16, 9, 0, 16], dtype=torch.int32, device='cuda')
    cases.append(('ring Sc=27 T=16', 27, 16, pos0, nv,
                  scattered_table(gen, B, 2, NP, [27] * B, ps)))
    written = []                                  # (label, Sc, T, pos0, jobs)
    for label, Sc, T, pos0, nv, table in cases:
        start = torch.div(pos0 % Sc, ps, rounding_mode='floor').long()
        pending = torch.stack([table[1, start[1]], table.new_tensor(NP - 1),
                               table.new_tensor(0)]).to(torch.int32)
        jobs = PM.build_jobs(pos0, nv, table, Sc, ps, T, pending)
        written.append((label, Sc, T, pos0, jobs))
        x = torch.randn((2, B, T, KV, d), generator=gen, device='cuda') * 3
        (kq, kscale), (vq, vscale) = _quantize(x[0]), _quantize(x[1])
        srcs = [kq, vq, kscale, vscale, PM.chunk_positions(pos0, T)]
        want = [PM.fused_page_write_plain(y.clone(), src, jobs, Sc=Sc, fill=f)
                for y, src, f in zip(leaves, srcs, fills)]
        n0 = PM.fused_page_write.launches
        PM.fused_page_write(leaves, srcs, jobs, Sc=Sc, fills=fills)
        torch.cuda.synchronize()
        assert PM.fused_page_write.launches == n0 + 1
        same_leaves(f'fused_page_write int8 {label}', leaves, want)
        msg = (f'[kernel] fused_page_write int8 leaves {label} (row bytes '
               f'{[y[0, 0].numel() * y.element_size() for y in leaves]}), '
               f'{jobs.shape[0]} jobs: bitwise equal')
        if label == 'linear T=1':
            n_w, n_f = write_counts(jobs, Sc, ps)
            rb = [y[0, 0].numel() * y.element_size() for y in leaves]
            b_ms, by = bound(n_w * 2 * sum(rb) + n_f * sum(rb) + nbytes(jobs),
                             0, torch.bfloat16)
            ms = time_ms(lambda: PM.fused_page_write(
                leaves, srcs, jobs, Sc=Sc, fills=fills))
            msg += f'; kernel {ms:.4f} ms, bound {b_ms:.6f} ms ({by})'
        log(msg)
    row = check_quantizing_write(gen, leaves, written)
    del leaves, k, v, ks, vs, pos
    reps = cfg.num_layers - 1
    k, v, ks, vs = int8_leaves(gen, (reps, NP, ps), KV, d)
    cache = dict(zip(names, (k, v, ks, vs, torch.randint(
        0, 4096, (reps, NP, ps), generator=gen, device='cuda',
        dtype=torch.int32))))
    for src, dst, rem in ((11, 900, 0), (12, 901, 7), (13, 902, ps)):
        sdr = torch.tensor([[src + r * NP, dst + r * NP, rem]
                            for r in range(reps)], dtype=torch.int32,
                           device='cuda')
        want = {nm: PM.cow_page_copy_plain(
            x.clone().view((reps * NP,) + tuple(x.shape[2:])), sdr,
            fill=PM.leaf_fill(nm)) for nm, x in cache.items()}
        n0 = PM.cow_page_copy.launches
        PM.cow_copy_cache(cache, src, dst, rem, reps=reps)
        torch.cuda.synchronize()
        assert PM.cow_page_copy.launches == n0 + 1
        for nm, x in cache.items():
            assert torch.equal(x.reshape(want[nm].shape), want[nm]), \
                f'cow_page_copy int8 rem={rem} {nm}'
    log(f'[kernel] cow_page_copy int8 leaves {list(names)} over {reps} '
        'layers, rem 0/7/16: bitwise equal, one launch per copy-on-write')
    del cache, k, v, ks, vs
    return row


def check_quantizing_write(gen, leaves, written, arch='glm4_9b',
                           edge_rings=(GLM_SEQ, 27)) -> dict:
    """The quantizing form of fused_page_write on ``arch``'s five int8
    leaves (``leaves``, the engine's pool) through the job lists of
    ``written`` ((label, Sc, T, pos0, jobs) of the int8-leaf writes), bf16
    and fp32 K/V values: bitwise its plain version
    (``quantize_rows`` + the plain write, torch's CUDA kernels), one
    launch. Then the edge rows of ``tests/_torch_scenarios.py`` (NaN,
    zeros, .5 ties, bf16's largest values, an amax at which division and
    reciprocal differ) at page sizes 1 and 16, T 1 and 16, a linear table
    and a ring (``edge_rings``: their Sc). bf16 at T 1 and 16 timed beside
    the launch floor, the
    eager quantizer on K and V alone, and the eager quantizer followed by
    the write of the five quantized leaves (the path before the
    quantizing form). -> times for the kernels line."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from _torch_scenarios import quant_write_case
    cfg = get_config(arch)
    KV, d, ps, B = cfg.num_kv_heads, cfg.head_dim, GLM_PS, GLM_SLOTS
    fills = [PM.leaf_fill(nm) for nm in QUANT_LEAVES]
    row = {}
    for label, Sc, T, pos0, jobs in written:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((2, B, T, KV, d), generator=gen, device='cuda')
                 * 3).to(dtype)
            vals = [x[0], x[1], None, None, PM.chunk_positions(pos0, T)]
            want = [PM.fused_page_write_plain(y.clone(), v, jobs, Sc=Sc,
                                              fill=f)
                    for y, v, f in zip(leaves, PM.quantized_values(
                        vals, QUANT_PAIRS), fills)]
            n0 = PM.fused_page_write.launches
            PM.fused_page_write(leaves, vals, jobs, Sc=Sc, fills=fills,
                                quantize=QUANT_PAIRS)
            torch.cuda.synchronize()
            assert PM.fused_page_write.launches == n0 + 1
            same_leaves(f'quantizing write {label} {dtype}', leaves, want)
            msg = (f'[kernel] fused_page_write quantizing {str(dtype)[6:]} '
                   f'{cfg.name} K/V (KV {KV}, d {d}) -> int8 leaves {label}, '
                   f'{jobs.shape[0]} jobs: bitwise the quantizer + plain '
                   'write, one launch')
            if dtype is torch.bfloat16 and label.startswith('linear'):
                n_w, n_f = write_counts(jobs, Sc, ps)
                rb = [y[0, 0].numel() * y.element_size() for y in leaves]
                # a written row reads its K and V rows and its position
                # once and writes every leaf's row; a filled row writes
                src = 2 * KV * d * x.element_size() + 4
                moved = n_w * (src + sum(rb)) + n_f * sum(rb) + nbytes(jobs)
                b_ms, by = bound(moved, 0, dtype)
                ms = time_ms(lambda: PM.fused_page_write(
                    leaves, vals, jobs, Sc=Sc, fills=fills,
                    quantize=QUANT_PAIRS))
                quant = time_ms(lambda: PM.quantized_values(vals,
                                                            QUANT_PAIRS))
                eager = time_ms(lambda: PM.fused_page_write(
                    leaves, PM.quantized_values(vals, QUANT_PAIRS), jobs,
                    Sc=Sc, fills=fills))
                n_eager = device_kernels(lambda: PM.fused_page_write(
                    leaves, PM.quantized_values(vals, QUANT_PAIRS), jobs,
                    Sc=Sc, fills=fills))
                n_dev = device_kernels(lambda: PM.fused_page_write(
                    leaves, vals, jobs, Sc=Sc, fills=fills,
                    quantize=QUANT_PAIRS))
                assert n_dev == 1, f'quantizing write {label}: {n_dev} ' \
                    'device kernels a call'
                msg += (f'; kernel {ms:.4f} ms (1 device kernel), eager '
                        f'quantizer on K and V {quant:.4f} ms, eager '
                        f'quantizer + write of the quantized leaves '
                        f'{eager:.4f} ms ({n_eager} device kernels), bound '
                        f'{b_ms:.6f} ms ({by})')
                key = 'quant_ms' if T == 1 else f'quant_t{T}_ms'
                row.update({key: ms, key.replace('quant', 'eager_quant'):
                            eager, key.replace('quant', 'quant_bound'): b_ms})
            log(msg)
    n_cases = 0
    for ps_, Sc, T, dtype in itertools.product(
            (1, 16), edge_rings, (1, 16), (torch.bfloat16, torch.float32)):
        pool, k, v, pos0, nv, table, pending = quant_write_case(
            ps_ + Sc + T, ps=ps_, Sc=Sc, T=T, KV=KV, hd=d)
        pools = [torch.from_numpy(pool[nm]).cuda() for nm in QUANT_LEAVES]
        pools[2:4] = [y.to(torch.bfloat16) for y in pools[2:4]]
        pos0, nv, table, pending = (torch.from_numpy(a).cuda()
                                    for a in (pos0, nv, table, pending))
        jobs = PM.build_jobs(pos0, nv, table, Sc, ps_, T, pending)
        vals = [torch.from_numpy(k).cuda().to(dtype),
                torch.from_numpy(v).cuda().to(dtype), None, None,
                PM.chunk_positions(pos0, T)]
        want = [PM.fused_page_write_plain(y.clone(), w, jobs, Sc=Sc, fill=f)
                for y, w, f in zip(pools, PM.quantized_values(
                    vals, QUANT_PAIRS), fills)]
        PM.fused_page_write(pools, vals, jobs, Sc=Sc, fills=fills,
                            quantize=QUANT_PAIRS)
        torch.cuda.synchronize()
        same_leaves(f'quantizing write edge rows ps={ps_} Sc={Sc} T={T} '
                    f'{dtype}', pools, want)
        n_cases += 1
    log(f'[kernel] fused_page_write quantizing, edge rows (NaN, zeros, .5 '
        f'ties, bf16 max, division vs reciprocal) at KV {KV} d {d}, page '
        f'sizes 1 and 16, Sc {" and ".join(map(str, edge_rings))}, T 1 and '
        f'16, bf16 and fp32: {n_cases} cases bitwise the quantizer + plain '
        'write')
    return row


def check_page_writes_pythia(gen) -> dict:
    """fused_page_write at pythia-6.9b's rows of 32 kv heads over the
    engine's pool, linear job lists at T 1 and 16 as phase 5's: bf16 k /
    v / pos bitwise the plain write, and the quantizing form (bf16 K/V
    into the five int8 leaves) bitwise the eager quantizer + the plain
    write; each timed with its bound (the plain write also with its plain
    version and the indexed copies). -> times by form and T."""
    cfg = get_config(PYTHIA)
    KV, d, ps, B = cfg.num_kv_heads, cfg.head_dim, GLM_PS, GLM_SLOTS
    NP, P = glm_pool_pages(), GLM_SEQ // GLM_PS
    k, v, pos = page_leaves(gen, torch.bfloat16, NP, ps, KV, d)
    qk, qv, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
    quant = [qk, qv, ks, vs, pos.clone()]
    for y, f in zip(quant, [PM.leaf_fill(nm) for nm in QUANT_LEAVES]):
        y[0] = f                                  # the null page
    out = {}
    for T in (1, 16):
        pos0 = torch.tensor([300, 272, 0, 365], dtype=torch.int32,
                            device='cuda')
        nv = torch.tensor([T, T, 0, 1], dtype=torch.int32, device='cuda')
        table = scattered_table(gen, B, P, NP, [300 + T, 272 + T, 0, 365 + T],
                                ps)
        pending = torch.stack([table[1, 272 // ps], table.new_tensor(NP - 1),
                               table.new_tensor(0)]).to(torch.int32)
        jobs = PM.build_jobs(pos0, nv, table, GLM_SEQ, ps, T, pending)
        n_w, n_f = write_counts(jobs, GLM_SEQ, ps)
        x = (torch.randn((2, B, T, KV, d), generator=gen, device='cuda')
             * 3).to(torch.bfloat16)
        pos_t = PM.chunk_positions(pos0, T)
        for form, leaves, vals, fills, pairs in (
                ('bf16', [k, v, pos], [x[0], x[1], pos_t], [0, 0, -1], []),
                ('quantizing', quant, [x[0], x[1], None, None, pos_t],
                 [PM.leaf_fill(nm) for nm in QUANT_LEAVES], QUANT_PAIRS)):
            plain_vals = PM.quantized_values(vals, pairs) if pairs else vals
            want = [PM.fused_page_write_plain(y.clone(), w, jobs, Sc=GLM_SEQ,
                                              fill=f)
                    for y, w, f in zip(leaves, plain_vals, fills)]
            n0 = PM.fused_page_write.launches
            PM.fused_page_write(leaves, vals, jobs, Sc=GLM_SEQ, fills=fills,
                                quantize=pairs)
            torch.cuda.synchronize()
            assert PM.fused_page_write.launches == n0 + 1
            for i, (g, w) in enumerate(zip(leaves, want)):
                bits = torch.int16 if g.dtype == torch.bfloat16 else g.dtype
                assert torch.equal(g.view(bits), w.view(bits)), \
                    f'fused_page_write pythia {form} T={T} leaf {i}'
            del want
            rb = [y[0, 0].numel() * y.element_size() for y in leaves]
            src = 2 * KV * d * x.element_size() + 4 if pairs else sum(rb)
            moved = n_w * (src + sum(rb)) + n_f * sum(rb) + nbytes(jobs)
            b_ms, by = bound(moved, 0, torch.bfloat16)
            ms = time_ms(lambda: PM.fused_page_write(
                leaves, vals, jobs, Sc=GLM_SEQ, fills=fills, quantize=pairs))
            r = dict(max_abs_err=0.0, ms=ms, bound_ms=b_ms, bound_by=by)
            text = f'kernel {ms:.4f} ms'
            if not pairs:
                r['plain_ms'] = time_ms(lambda: [PM.fused_page_write_plain(
                    y, w, jobs, Sc=GLM_SEQ, fill=f)
                    for y, w, f in zip(leaves, vals, fills)])
                r['library_ms'] = library_page_write_ms(leaves, vals, jobs,
                                                        GLM_SEQ, ps)
                text += (f', plain {r["plain_ms"]:.4f} ms, index_copy_ x3 '
                         f'(no clears) {r["library_ms"]:.4f} ms')
            log(f'[kernel] fused_page_write {form} pythia-6.9b KV={KV} d={d} '
                f'linear T={T} ({jobs.shape[0]} jobs, {n_w} rows written, '
                f'{n_f} filled): bitwise equal; {text}, bound {b_ms:.6f} ms '
                f'({by})')
            out.setdefault(form, {})[T] = r
    del k, v, pos, quant, qk, qv, ks, vs
    free()
    return out


# ------------------------------- phase 3: mistral-7b ring pages (paged)
RING_PS, RING_SEQ, RING_SLOTS = 16, 4608, 4
# tokens held by the 4 slots of the ring checks: every ring wrapped
RING_LENGTHS = (4400, 4700, 4171, 4608)


def ring_geometry():
    """(Sc, ring pages a slot, the engine's default pool) of paged
    mistral-7b at page 16, max_seq 4608, chunk 16, 4 slots."""
    cfg = get_config('mistral_7b')
    Sc = A.cache_len(cfg.window, RING_SEQ, 16)
    P = -(-Sc // RING_PS)
    lin = RING_SEQ // RING_PS
    return Sc, P, 1 + RING_SLOTS * (lin + P) + 8 * lin


def ring_pool(gen, Sc, P, NP):
    """A scattered ring table over the pool and the position leaf of slots
    holding ``RING_LENGTHS`` tokens: row ``p % Sc`` of each slot holds its
    position p for the last Sc positions; the rows past Sc of each ring's
    partial last page, as every unwritten row, hold -1. -> table, cpos."""
    table = scattered_table(gen, RING_SLOTS, P, NP, [Sc] * RING_SLOTS,
                            RING_PS)
    cpos = torch.full((NP, RING_PS), -1, dtype=torch.int32, device='cuda')
    for b, n in enumerate(RING_LENGTHS):
        p = torch.arange(n - Sc, n, device='cuda')
        idx = p % Sc
        cpos[table[b, idx // RING_PS].long(), idx % RING_PS] = \
            p.to(torch.int32)
    return table, cpos


def check_ring_pages(gen, floor: float) -> dict:
    """The paged mistral-7b engine's ring shapes: Sc 4111 (window 4096 +
    15), 257 ring pages a slot scattered over the engine's 4485-page pool,
    4 slots, KV 8, G 4, d 128. paged_attention (bf16) and
    paged_attention_quant (bf16 q over int8 pages) at T 1 and 16 through
    the ring table, held as the other attends are; fused_page_write (bf16
    k / v / pos, and the quantizing form into the five int8 leaves) with
    ring job lists at T 1 (a decode step), T 16 (a prefill step), and T 16
    with every ring page of the 4 slots pending (a wave's first step: 4 x
    257 deferred clears). Each timed with its bound, its plain version,
    the library call (sdpa on the gathered view; index_copy_ of the chunk
    rows) and beside the launch floor ``floor``. -> rows by kernel."""
    cfg = get_config('mistral_7b')
    KV, d, G = cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_heads // cfg.num_kv_heads
    Sc, P, NP = ring_geometry()
    B, ps, window = RING_SLOTS, RING_PS, cfg.window
    out = {'paged_attention': {}, 'paged_attention_quant': {},
           'fused_page_write': {}}
    k, v, _ = page_leaves(gen, torch.bfloat16, NP, ps, KV, d)
    table, cpos = ring_pool(gen, Sc, P, NP)
    k[0], v[0] = 0, 0
    view = paged_view({'k': k, 'v': v, 'pos': cpos}, table, Sc)
    assert bool((view['pos'] >= 0).all()), 'every ring row is written'
    assert int((cpos >= 0).sum()) == B * Sc, 'rows past Sc stay -1'
    for T in (1, 16):
        pos0 = torch.tensor([n - T for n in RING_LENGTHS], dtype=torch.int32,
                            device='cuda')
        q = torch.randn((B, T, KV, G, d), generator=gen,
                        device='cuda').to(torch.bfloat16)
        args = (q, k, v, cpos, table, pos0)
        kw = dict(scale=d ** -0.5, window=window)
        got = paged_attention(*args, **kw)
        want = paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        held = check_paged_bf16(f'mistral ring T={T}', got, want, args, kw)
        ms = time_ms(lambda: paged_attention(*args, **kw))
        plain = time_ms(lambda: paged_attention_plain(*args, **kw))
        lib = library_attention_ms(q, view['k'], view['v'], view['pos'],
                                   pos0, window)
        b_ms, by = attention_bound(q, view['k'], view['pos'], pos0, window,
                                   torch.bfloat16)
        log(f'[kernel] paged_attention bf16 mistral ring B={B} KV={KV} G={G} '
            f'T={T} Sc={Sc} window={window}, {P} ring pages a slot scattered '
            f'over NP={NP}: max |err| {err:.3g} (tol 2e-2; {held}); kernel '
            f'{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound '
            f'{b_ms:.4f} ms ({by})')
        out['paged_attention'][T] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=lib)
    del k, v, view
    qk, qv, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
    for x in (qk, qv, ks, vs):
        x[0] = 0
    view_pos = paged_view({'pos': cpos}, table, Sc)['pos']
    for T in (1, 16):
        pos0 = torch.tensor([n - T for n in RING_LENGTHS], dtype=torch.int32,
                            device='cuda')
        q = torch.randn((B, T, KV, G, d), generator=gen,
                        device='cuda').to(torch.bfloat16)
        out['paged_attention_quant'][T] = check_quant_case(
            f'mistral ring Sc={Sc} {P} pages a slot over NP={NP} T={T}',
            (q, qk, qv, ks, vs, cpos, table, pos0),
            dict(scale=d ** -0.5, window=window), view_pos, empty=False)
    del qk, qv, ks, vs
    free()
    # the ring writes: chunks at each slot's next positions
    k, v, pos = page_leaves(gen, torch.bfloat16, NP, ps, KV, d)
    qk, qv, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
    quant = [qk, qv, ks, vs, pos.clone()]
    for y, f in zip(quant, [PM.leaf_fill(nm) for nm in QUANT_LEAVES]):
        y[0] = f                                  # the null page
    ring_pages = table[table > 0].to(torch.int32)
    for label, T, pending in (('T=1', 1, table.new_zeros(0)),
                              ('T=16', 16, table.new_zeros(0)),
                              (f'T=16, {ring_pages.numel()} pending', 16,
                               ring_pages)):
        pos0 = torch.tensor(RING_LENGTHS, dtype=torch.int32, device='cuda')
        nv = torch.full((B,), T, dtype=torch.int32, device='cuda')
        jobs = PM.build_jobs(pos0, nv, table, Sc, ps, T, pending)
        n_w, n_f = write_counts(jobs, Sc, ps)
        x = (torch.randn((2, B, T, KV, d), generator=gen, device='cuda')
             * 3).to(torch.bfloat16)
        pos_t = PM.chunk_positions(pos0, T)
        for form, leaves, vals, fills, pairs in (
                ('bf16', [k, v, pos], [x[0], x[1], pos_t], [0, 0, -1], []),
                ('quantizing', quant, [x[0], x[1], None, None, pos_t],
                 [PM.leaf_fill(nm) for nm in QUANT_LEAVES], QUANT_PAIRS)):
            plain_vals = PM.quantized_values(vals, pairs) if pairs else vals
            want = [PM.fused_page_write_plain(y.clone(), w, jobs, Sc=Sc,
                                              fill=f)
                    for y, w, f in zip(leaves, plain_vals, fills)]
            n0 = PM.fused_page_write.launches
            PM.fused_page_write(leaves, vals, jobs, Sc=Sc, fills=fills,
                                quantize=pairs)
            torch.cuda.synchronize()
            assert PM.fused_page_write.launches == n0 + 1
            for i, (g, w, f) in enumerate(zip(leaves, want, fills)):
                bits = torch.int16 if g.dtype == torch.bfloat16 else g.dtype
                assert torch.equal(g.view(bits), w.view(bits)), \
                    f'fused_page_write {form} mistral ring {label} leaf {i}'
                assert bool((g[0] == f).all()), 'the null page was written'
            del want
            rb = [y[0, 0].numel() * y.element_size() for y in leaves]
            src = 2 * KV * d * x.element_size() + 4 if pairs else sum(rb)
            moved = n_w * (src + sum(rb)) + n_f * sum(rb) + nbytes(jobs)
            b_ms, by = bound(moved, 0, torch.bfloat16)
            ms = time_ms(lambda: PM.fused_page_write(
                leaves, vals, jobs, Sc=Sc, fills=fills, quantize=pairs))
            plain = time_ms(lambda: [PM.fused_page_write_plain(
                y, w, jobs, Sc=Sc, fill=f)
                for y, w, f in zip(leaves, plain_vals, fills)])
            lib = library_page_write_ms(leaves, plain_vals, jobs, Sc, ps)
            log(f'[kernel] fused_page_write {form} mistral ring Sc={Sc} '
                f'{label} KV={KV} d={d} ({jobs.shape[0]} jobs, {n_w} rows '
                f'written, {n_f} filled, NP={NP}): bitwise the plain write; '
                f'kernel {ms:.4f} ms, plain {plain:.4f} ms, index_copy_ x'
                f'{len(leaves)} (no clears) {lib:.4f} ms, launch floor '
                f'{floor:.4f} ms, bound {b_ms:.6f} ms ({by})')
            out['fused_page_write'].setdefault(form, {})[label] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=lib, launch_floor_ms=floor)
    del k, v, pos, quant, qk, qv, ks, vs
    free()
    return out


def same_leaves(label, got, want) -> None:
    """Every pool leaf bitwise (bf16 scales compared as bits: NaN too)."""
    for nm, g, w in zip(QUANT_LEAVES, got, want):
        bits = torch.int16 if g.dtype == torch.bfloat16 else g.dtype
        assert torch.equal(g.view(bits), w.view(bits)), f'{label}: {nm}'


# ------- phase 3: the split kernels' engines (gemma3-1b: head width 256;
# internvl2-1b: d 64, G 7) and their pools
# the engines' geometry: 4 slots, page 16, chunk 16, max_seq 2048; the
# attend checks' slots hold SPLIT_LENGTHS tokens (a local layer's ring
# wraps in slots 0 and 3; slot 2 is empty)
SPLIT_SEQ = 2048
SPLIT_LENGTHS = (1300, 700, 0, 1100)


def split_attend_cases(gen, quant, arch='gemma3_1b'):
    """The attend of ``arch``'s paged engine (gemma3-1b: KV 1, G 4, d 256;
    internvl2-1b: KV 2, G 7, d 64) on its pool, through a scattered table
    (4 slots of ``SPLIT_LENGTHS`` tokens, page 16, max_seq 2048): each
    layer kind the config has, a local layer's ring of cache_len(512,
    2048, 16) = 527 positions a slot (33 ring pages; position p at ring
    index p % 527) and a global layer's linear pages; bf16 pages, or int8
    with bf16 scales (``quant``); bf16 queries at T 1 and 16. Yields
    (label, the arguments of paged_attention or paged_attention_quant,
    kwargs, the dense view of the slots' k / v / positions)."""
    cfg = get_config(arch)
    KV, d, ps, B = cfg.num_kv_heads, cfg.head_dim, RING_PS, RING_SLOTS
    G = cfg.num_heads // KV
    for kind in ('local', 'global'):
        if kind not in cfg.pattern:
            continue
        window = cfg.layer_window(kind)
        Sc = A.cache_len(window, SPLIT_SEQ, 16)
        P = -(-Sc // ps)
        NP = 1 + B * P
        if quant:
            pages = int8_leaves(gen, (NP, ps), KV, d)
            k, v = pages[:2]
        else:
            k, v, _ = page_leaves(gen, torch.bfloat16, NP, ps, KV, d)
            pages = (k, v)
        table = scattered_table(gen, B, P, NP,
                                [min(n, Sc) for n in SPLIT_LENGTHS], ps)
        cpos = torch.full((NP, ps), -1, dtype=torch.int32, device='cuda')
        for b, n in enumerate(SPLIT_LENGTHS):
            p = torch.arange(max(0, n - Sc), n, device='cuda')
            idx = p % Sc
            cpos[table[b, idx // ps].long(), idx % ps] = p.to(torch.int32)
        view = paged_view({'k': k, 'v': v, 'pos': cpos}, table, Sc)
        for T in (1, 16):
            pos0 = torch.tensor([max(n - T, 0) for n in SPLIT_LENGTHS],
                                dtype=torch.int32, device='cuda')
            q = torch.randn((B, T, KV, G, d), generator=gen,
                            device='cuda').to(torch.bfloat16)
            yield (f'{cfg.name} {kind} Sc={Sc} T={T}',
                   (q, *pages, cpos, table, pos0),
                   dict(scale=d ** -0.5, window=window), view)
        del pages, k, v, cpos, table, view


def check_engine_kernels(gen, arch) -> dict:
    """The paged engine's kernels at ``arch``'s shapes (gemma3-1b: KV 1, G
    4, d 256; internvl2-1b: KV 2, G 7, d 64). The split paged_attention
    (:func:`check_split_attends`); fused_page_write on bf16 k / v / pos
    leaves (:func:`check_fused_page_write`) and in its quantizing form
    (:func:`check_quantizing_write_pool`); cow_page_copy over its stacked
    layers' pages, bf16 and int8 leaves. -> rows by kernel, keyed '<kind>
    Sc=<Sc> T=<T>' for the attends."""
    out = check_split_attends(gen, arch)
    out['fused_page_write'] = dict(
        check_fused_page_write(gen, arch, (torch.bfloat16,)),
        **check_quantizing_write_pool(gen, arch))
    out['cow_page_copy'] = check_cow_pages(gen, arch, ('bf16', 'int8'),
                                           PYTHIA_COW_NP)
    free()
    return out


def check_split_attends(gen, arch) -> dict:
    """The split paged_attention at ``arch``'s engine shapes
    (``split_attend_cases``): the dense form held within 2e-2 and by
    ``check_paged_bf16`` (the row-scaled limit; T 16 rows bitwise
    one-token calls), the int8 form by ``check_quant_case``, timed with
    the plain version, sdpa (bf16) and the bound. -> rows of both forms,
    keyed '<kind> Sc=<Sc> T=<T>'."""
    cfg = get_config(arch)
    KV, d = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    out = {'paged_attention': {}, 'paged_attention_quant': {}}
    for label, args, kw, view in split_attend_cases(gen, False, arch):
        q, pos0 = args[0], args[-1]
        assert split_form(q, args[1], args[2]), label
        got = paged_attention(*args, **kw)
        want = paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert not got[2].any(), 'empty slot must attend to zeros'
        held = check_paged_bf16(label, got, want, args, kw)
        del got, want
        ms = time_ms(lambda: paged_attention(*args, **kw))
        plain = time_ms(lambda: paged_attention_plain(*args, **kw))
        lib = library_attention_ms(q, view['k'], view['v'], view['pos'],
                                   pos0, kw['window'])
        b_ms, by = attention_bound(q, view['k'], view['pos'], pos0,
                                   kw['window'], torch.bfloat16)
        log(f'[kernel] paged_attention bf16 {label} B={q.shape[0]} KV={KV} '
            f'G={G} d={d} scattered table: split kernel; max |err| {err:.3g} '
            f'(tol 2e-2; {held}), empty slot zeros; kernel {ms:.4f} ms, '
            f'plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms '
            f'({by})')
        key = label.split(' ', 1)[1]
        out['paged_attention'][key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=lib)
    for label, args, kw, view in split_attend_cases(gen, True, arch):
        assert quant_split_form(args[0], args[1]), label
        out['paged_attention_quant'][label.split(' ', 1)[1]] = \
            check_quant_case(label, args, kw, view['pos'])
    free()
    return out


# hymba-1.5b's dense engine (phase 13): 4 slots, chunk 16, max_seq 2048;
# the slots hold SPLIT_LENGTHS tokens (a windowed layer's ring wraps in
# slots 0 and 3; slot 2 is empty)
HYMBA_SEQ = 2048


def check_hymba_attends(gen) -> dict:
    """The split paged_attention at hymba-1.5b's engine shapes (KV 5, G 5,
    d 64), on its dense caches viewed as identity-table pages as the cuda
    backend views them: a windowed layer's ring of cache_len(1024, 2048,
    16) = 1039 positions and a global layer's 2048, bf16, T 1 and 16
    (:func:`ring_case`). Held within 2e-2 and by ``check_paged_bf16`` (the
    row-scaled limit; T 16 rows bitwise one-token calls), timed with the
    plain version, sdpa and the bound. -> rows keyed '<kind> Sc=<Sc>
    T=<T>'."""
    cfg = get_config('hymba_1_5b')
    KV, d = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    out = {}
    for kind in ('hybrid', 'hybrid_global'):
        window = cfg.layer_window(kind)
        Sc = A.cache_len(window, HYMBA_SEQ, 16)
        for T in (1, 16):
            args, (k, v, cpos) = ring_case(gen, torch.bfloat16, RING_SLOTS,
                                           T, KV, G, d, Sc, SPLIT_LENGTHS)
            label = f'{kind} Sc={Sc} T={T}'
            kw = dict(scale=d ** -0.5, window=window)
            assert split_form(args[0], args[1], args[2]), label
            got = paged_attention(*args, **kw)
            want = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
            assert not got[2].any(), 'empty slot must attend to zeros'
            held = check_paged_bf16(f'hymba {label}', got, want, args, kw)
            del got, want
            ms = time_ms(lambda: paged_attention(*args, **kw))
            plain = time_ms(lambda: paged_attention_plain(*args, **kw))
            lib = library_attention_ms(args[0], k, v, cpos, args[5], window)
            b_ms, by = attention_bound(args[0], k, cpos, args[5], window,
                                       torch.bfloat16)
            log(f'[kernel] paged_attention bf16 {cfg.name} {label} '
                f'B={RING_SLOTS} KV={KV} G={G} d={d} dense caches as '
                f'identity-table pages: split kernel; max |err| {err:.3g} '
                f'(tol 2e-2; {held}), empty slot zeros; kernel {ms:.4f} ms, '
                f'plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} '
                f'ms ({by})')
            out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=b_ms, bound_by=by, library_ms=lib)
            del args, k, v, cpos
    free()
    return out


def check_quantizing_write_pool(gen, arch) -> dict:
    """:func:`check_quantizing_write` at ``arch``'s pool rows (gemma3-1b:
    KV 1, d 256, one head's values over the 32 lanes of a warp;
    internvl2-1b: KV 2, d 64, 8 lanes a head, so 4 heads share a warp and
    half its lanes are past the heads) on the five int8 leaves of its
    engine's default pool: linear job lists at T 1 and 16 and a ring at T
    16 (a local layer's, Sc 527; a model without local layers takes
    glm4-9b's Sc 27), then the edge rows over a linear table and that
    ring. -> its times."""
    cfg = get_config(arch)
    KV, d, ps, B = cfg.num_kv_heads, cfg.head_dim, RING_PS, RING_SLOTS
    Sc_ring = A.cache_len(cfg.window, SPLIT_SEQ, 16) \
        if 'local' in cfg.pattern else 27
    lin, ring = SPLIT_SEQ // ps, -(-Sc_ring // ps)
    NP = 1 + B * (lin + ring) + 8 * lin
    k, v, ks, vs = int8_leaves(gen, (NP, ps), KV, d)
    pos = torch.randint(0, 4096, (NP, ps), generator=gen, device='cuda',
                        dtype=torch.int32)
    leaves = [k, v, ks, vs, pos]
    for x, nm in zip(leaves, QUANT_LEAVES):
        x[0] = PM.leaf_fill(nm)                   # the null page
    cases = [(f'linear T={T}', SPLIT_SEQ, T, [1300, 700, 0, 1100],
              [T, T, 0, 1], scattered_table(gen, B, lin, NP,
                                            [1300 + T, 700 + T, 0, 1101], ps))
             for T in (1, 16)]
    cases.append((f'ring Sc={Sc_ring} T=16', Sc_ring, 16, [1300, 520, 0, 1100],
                  [16, 9, 0, 16],
                  scattered_table(gen, B, ring, NP, [Sc_ring] * B, ps)))
    written = []
    for label, Sc, T, pos0, nv, table in cases:
        pos0, nv = (torch.tensor(x, dtype=torch.int32, device='cuda')
                    for x in (pos0, nv))
        start = torch.div(pos0 % Sc, ps, rounding_mode='floor').long()
        pending = torch.stack([table[1, start[1]], table.new_tensor(NP - 1),
                               table.new_tensor(0)]).to(torch.int32)
        written.append((label, Sc, T, pos0,
                        PM.build_jobs(pos0, nv, table, Sc, ps, T, pending)))
    row = check_quantizing_write(gen, leaves, written, arch,
                                 (SPLIT_SEQ, Sc_ring))
    del leaves, k, v, ks, vs, pos
    return row


# --------------------------------- phase 3: full-sequence flash attention
# (config, S, window): the shapes Model.apply gives the flash kernel
# (mistral-7b S 8192 with its 4096 window, glm4-9b S 4096 causal,
# pythia-6.9b S 2048 over 32 kv heads, gemma3-1b S 4096 at d 256 over one
# kv head, a local layer's 512 window and a global layer, internvl2-1b S
# 4096 at d 64 over 14 heads of 2 kv heads: G 7, llama3-405b S 4096 over
# 128 heads of 8 kv heads: G 16, hymba-1.5b S 2048 + its 128 meta tokens
# over 25 heads of 5 kv heads at d 64, a windowed layer's 1024 and a
# global layer) and a ragged S (not a multiple of any tile)
# Model.apply of hymba-1.5b in phase 13: 2048 tokens after 128 meta tokens
HYMBA_APPLY_S = 2048 + 128
FLASH_CASES = (('mistral_7b', 8192, 4096), ('glm4_9b', 4096, 0),
               ('glm4_9b', 4097, 0), ('pythia_6_9b', 2048, 0),
               ('gemma3_1b', 4096, 512), ('gemma3_1b', 4096, 0),
               ('internvl2_1b', 4096, 0), ('llama3_405b', 4096, 0),
               ('hymba_1_5b', HYMBA_APPLY_S, 1024),
               ('hymba_1_5b', HYMBA_APPLY_S, 0))
# tests/test_kernels.py's tolerances (2e-5 fp32, 3e-2 bf16); and in bf16 a
# limit scaled by the output, |err| <= 0.02 rms(row) + 0.016 |want|: the
# kernel rounds its probabilities to bf16 (2^-9 relative), an error that
# scales with the row's RMS, and its output (one bf16 step is at most
# 2^-7 |o|). At 4096 keys a row's RMS is ~0.026 (randn inputs), so the
# limit there is ~5e-4 where 3e-2 is as large as the output; a skipped
# 64-key tile moves a row by ~8 / sqrt(keys) of its RMS.
# scripts/flash_mutants.py runs planted faults against it.
FLASH_TOL = {torch.bfloat16: dict(atol=3e-2, rtol=3e-2),
             torch.float32: dict(atol=2e-5, rtol=2e-5)}
FLASH_ROW_TOL = dict(row=0.02, rtol=0.016)


def flash_pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one head, causal, within the window:
    the work this run's inputs need."""
    i = torch.arange(S, dtype=torch.int64)
    lo = (i - window + 1).clamp(min=0) if window else torch.zeros_like(i)
    return int((i - lo + 1).sum())


def flash_error(got, want):
    """The largest |got - want|, and the largest share of the limit
    ``FLASH_ROW_TOL['row'] * rms(row of want) + FLASH_ROW_TOL['rtol'] *
    |want|`` that any element uses (over 1 fails)."""
    want = want.float()
    diff = (got.float() - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    limit = (FLASH_ROW_TOL['row'] * rms
             + FLASH_ROW_TOL['rtol'] * want.abs()).clamp_min(1e-30)
    return diff.max().item(), (diff / limit).max().item()


def check_flash(got, want, dtype) -> tuple:
    """Holds flash_attention's output against its plain version:
    ``FLASH_TOL``, and in bf16 also ``FLASH_ROW_TOL``. Returns
    :func:`flash_error`."""
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    err, share = flash_error(got, want)
    if dtype is torch.bfloat16 and share > 1:
        raise AssertionError(f'flash_attention: max |err| {err:.3g} uses '
                             f'{share:.3f} of the limit {FLASH_ROW_TOL}')
    return err, share


def library_flash_ms(q, k, v, window) -> float:
    """F.scaled_dot_product_attention with enable_gqa: is_causal for a
    causal layer, a boolean band mask for a windowed one — a yardstick
    only; the port never calls it."""
    S = q.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        i = torch.arange(S, device='cuda')
        band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        return time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=band, enable_gqa=True), 3, 3)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), 3, 3)


def check_flash_attention(gen) -> dict:
    """flash_attention against its plain version at the shapes of the
    Model.apply phases and a ragged S, bf16 and fp32 (:func:`check_flash`);
    timed with the plain version, the library call (bf16) and the
    bound."""
    row = {}
    for name, S, window in FLASH_CASES:
        cfg = get_config(name)
        H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos = torch.arange(S, dtype=torch.int32, device='cuda')[None]
        pairs = flash_pairs(S, window)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((1, S, H, d), generator=gen,
                            device='cuda').to(dtype)
            k = torch.randn((1, S, KV, d), generator=gen,
                            device='cuda').to(dtype)
            v = torch.randn((1, S, KV, d), generator=gen,
                            device='cuda').to(dtype)
            kw = dict(window=window)
            got = flash_attention(q, k, v, pos, **kw)
            want = flash_attention_plain(q, k, v, pos, **kw)
            torch.cuda.synchronize()
            err, share = check_flash(got, want, dtype)
            del got, want
            ms = time_ms(lambda: flash_attention(q, k, v, pos, **kw), 3, 3)
            plain = time_ms(lambda: flash_attention_plain(q, k, v, pos, **kw),
                            1, 2)
            lib = library_flash_ms(q, k, v, window) \
                if dtype is torch.bfloat16 else None
            b_ms, by = bound(2 * nbytes(q) + nbytes(k, v, pos),
                             4 * d * H * pairs, dtype)
            log(f'[kernel] flash_attention {str(dtype)[6:]} {cfg.name} B=1 '
                f'S={S} H={H} KV={KV} d={d} window={window} ({pairs} visible '
                f'pairs a head): max |err| {err:.3g} (tol {FLASH_TOL[dtype]}'
                + (f'; {share:.3f} of the limit {FLASH_ROW_TOL}'
                   if dtype is torch.bfloat16 else '') + '); kernel '
                f'{ms:.4f} ms, plain {plain:.4f} ms, sdpa '
                + (f'{lib:.4f} ms' if lib is not None else 'not timed')
                + f', bound {b_ms:.4f} ms ({by})')
            if (name, S, dtype) == ('mistral_7b', 8192, torch.bfloat16):
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=lib)
            if name.startswith(('gemma', 'internvl', 'llama3', 'hymba')) \
                    and dtype is torch.bfloat16:
                row.setdefault(name, {})[f'window {window}'] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=by, library_ms=lib)
            del q, k, v
            free()
    return row


# --------------------- phases 4-5: layer 0, baseline against precomputed
LAYER0_COUNTS = (1, 4, 64, 4096)
RMS_TOL = 3e-2                       # bf16, tests/test_kernels.py
# bf16 rmsnorm_matmul also within a row-scaled limit: one bf16 step of the
# output (at most 2^-7 |o|) and 1e-3 of the row's RMS. The kernels keep 16
# bits of the normalised row (hi/lo, or fp32 at decode sizes), so they differ
# from the fp32 plain version by the output's rounding and ~1e-5 rms; one
# bf16 product (8 bits of the row) errs by ~1.1e-3 rms per element (2^-9 /
# sqrt(3) of each term, summed over d), which RMS_TOL cannot see.
# scripts/rmsnorm_mutants.py runs planted faults and that build against it.
RMS_ROW_TOL = dict(row=1e-3, rtol=2 ** -7)
COLD_COPIES = 3                      # weight sets rotated between launches


def rms_error(got, want):
    """The largest |got - want| and the largest share of the limit
    ``RMS_ROW_TOL['row'] * rms(row of want) + RMS_ROW_TOL['rtol'] * |want|``
    that any element uses (over 1 fails)."""
    want = want.float()
    diff = (got.float() - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    limit = (RMS_ROW_TOL['row'] * rms
             + RMS_ROW_TOL['rtol'] * want.abs()).clamp_min(1e-30)
    return diff.max().item(), (diff / limit).max().item()


def check_rms(got, want) -> tuple:
    """Holds bf16 rmsnorm_qkv outputs (q, k, v) against the plain
    version's: ``RMS_TOL``, then ``RMS_ROW_TOL``. -> (max |err|, largest
    share of the row limit)."""
    errs = []
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=RMS_TOL,
                                   rtol=RMS_TOL)
        errs.append(rms_error(g, w))
    err, share = max(e for e, _ in errs), max(s for _, s in errs)
    if share > 1:
        raise AssertionError(f'rmsnorm_matmul: max |err| {err:.3g} uses '
                             f'{share:.3f} of the limit {RMS_ROW_TOL}')
    return err, share


def library_hilo(x, scale, wcat2):
    """The same-precision library call: F.rms_norm in fp32, the rows split
    into bf16 hi and lo, one torch.matmul of [hi | lo] by [W; W] (wcat2,
    made once). A yardstick only; the port never calls it."""
    xn = F.rms_norm(x.float(), (x.shape[-1],), scale.float(), EPS)
    hi = xn.to(torch.bfloat16)
    lo = (xn - hi.float()).to(torch.bfloat16)
    return torch.matmul(torch.cat([hi, lo], dim=-1), wcat2)


def check_layer0(model, params, table, counts, rows) -> None:
    """The paper's layer-0 comparison at full width on the model's own
    weights and table: baseline = the embedding row read + rmsnorm_matmul
    over [Wq|Wk|Wv] (three weight pointers, one call); library baseline
    = the same rows + F.rms_norm + torch.matmul over the concatenated
    weights (made once, outside the timing); precomputed = embed_gather of
    the table's rows. Holds rmsnorm_matmul against its plain version
    (``check_rms``) at each N and times kernel (the form its shape takes),
    plain version, the single-pass library call (F.rms_norm +
    torch.matmul: 8 bits of the normalised row), the same-precision one
    (``library_hilo``) and the bound. Launches rotate over COLD_COPIES
    weight copies and 16 id sets, so each replay reads its weights and
    rows from device memory, as a decode step that ran other layers
    between two layer-0 reads would. gemma3: the rows read are scaled by
    sqrt(d) in bf16 and both baselines end with the per-head qk_norm, as
    layer 0 runs them (the table holds both folded in). The kernels line's
    row is mistral-7b N 8192's; its ``at_n`` holds every config's and
    N's."""
    cfg = model.cfg
    lay0 = params['backbone']['layer0']
    scale = lay0['ln1']['scale']
    att = lay0['attn']
    ws = [att[nm]['w'] for nm in ('wq', 'wk', 'wv')]
    q_w, k_w = ws[0].shape[1], ws[1].shape[1]
    emb_scale = torch.tensor(cfg.d_model ** 0.5, dtype=ws[0].dtype,
                             device='cuda') if cfg.embed_scale else None

    def rows_of(t):
        """The embedding rows layer 0 reads (scaled by sqrt(d) in gemma3)."""
        x = params['embed']['table'][t.long()]
        return x if emb_scale is None else x * emb_scale

    def qk(q, k, v):
        """qk_norm after the projections (gemma3); nothing elsewhere."""
        return (*A.qk_normalize(att, q, k, cfg), v)

    def qk_cat(y):
        return qk(y[..., :q_w], y[..., q_w:q_w + k_w], y[..., q_w + k_w:]) \
            if cfg.qk_norm else y
    sets = [ws] + [[w.clone() for w in ws] for _ in range(COLD_COPIES - 1)]
    cats = [torch.cat(s, dim=1) for s in sets]
    cat2 = torch.cat([cats[0], cats[0]], dim=0)
    embed, rows_tab = params['embed']['table'], table.table
    d, W, es = cfg.d_model, cats[0].shape[1], embed.element_size()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    at_n = {}
    for n in counts:
        ids = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device='cuda', dtype=torch.int32)
               for _ in range(16)]
        x = rows_of(ids[0])
        form = rmsnorm_matmul_form(x, ws)
        n0 = rmsnorm_matmul.launches
        got = rmsnorm_qkv(x, scale, *ws)
        assert rmsnorm_matmul.launches == n0 + 1
        want = rmsnorm_qkv_plain(x, scale, *ws)
        torch.cuda.synchronize()
        err, share = check_rms(got, want)
        del got, want
        calls = [0]

        def pick():
            calls[0] += 1
            return calls[0] % COLD_COPIES, ids[calls[0] % 16]
        it = (20, 5) if n <= 64 else (3, 3)

        def kernel():
            i, _ = pick()
            return rmsnorm_qkv(x, scale, *sets[i])

        def plain():
            i, _ = pick()
            return rmsnorm_qkv_plain(x, scale, *sets[i])

        def library():
            i, _ = pick()
            return torch.matmul(F.rms_norm(x, (d,), scale, EPS), cats[i])

        def same_precision():
            return library_hilo(x, scale, cat2)

        def baseline():
            i, t = pick()
            return qk(*rmsnorm_qkv(rows_of(t), scale, *sets[i]))

        def baseline_lib():
            i, t = pick()
            return qk_cat(torch.matmul(F.rms_norm(rows_of(t), (d,), scale,
                                                  EPS), cats[i]))

        def precomputed():
            return embed_gather(rows_tab, pick()[1])
        ms, plain_ms, lib_ms, hilo_ms = (
            time_ms(f, *it) for f in (kernel, plain, library, same_precision))
        b_ms, by = bound(nbytes(x, scale, cats[0]) + n * W * es,
                         2 * n * d * W, x.dtype)
        log(f'[kernel] rmsnorm_matmul bf16 {cfg.name} N={n} d={d} W={W} '
            f'(q/k/v {[w.shape[1] for w in ws]}), form {form}: max |err| '
            f'{err:.3g} (tol {RMS_TOL}; {share:.3f} of the row limit '
            f'{RMS_ROW_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
            f'F.rms_norm + torch.matmul {lib_ms:.4f} ms, same precision '
            f'(hi/lo rows, one torch.matmul by [W; W]) {hilo_ms:.4f} ms, '
            f'bound {b_ms:.4f} ms ({by})')
        at_n[n] = dict(form=form, max_abs_err=err, limit_share=share, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_hilo_ms=hilo_ms, bound_ms=b_ms)
        if (cfg.name, n) == ('mistral-7b', counts[-1]):
            rows.setdefault('rmsnorm_matmul', {}).update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=lib_ms, library_hilo_ms=hilo_ms)
        base, base_lib, pre = (time_ms(f, *it) for f in
                               (baseline, baseline_lib, precomputed))
        base_bytes = n * d * es + d * es + d * W * es
        pre_bytes = n * rows_tab.shape[1] * es
        extra = (' x sqrt(d)' if cfg.embed_scale else '') + (
            ' + qk_norm' if cfg.qk_norm else '')
        log(f'[layer0] {cfg.name} N={n}: baseline (embedding rows{extra} + '
            f'rmsnorm_matmul) {base:.4f} ms, {base_bytes} bytes read; library '
            f'baseline (rows + F.rms_norm + torch.matmul{extra}) '
            f'{base_lib:.4f} ms; '
            f'precomputed (embed_gather of {rows_tab.shape[1]}-wide rows) '
            f'{pre:.4f} ms, {pre_bytes} bytes read; baseline / precomputed '
            f'{base / pre:.1f}x, library baseline / precomputed '
            f'{base_lib / pre:.1f}x, bytes {base_bytes / pre_bytes:.1f}x')
        del x, ids
    rows.setdefault('rmsnorm_matmul', {}).setdefault('at_n', {})[
        cfg.name] = at_n
    del sets, cats, cat2
    free()


# logits of two bf16 forwards (or of a forward and the engine) that differ in
# rounding only: logits are ~N(0, 1) at these random weights and bf16 steps
# are 2^-6..2^-5 at magnitudes 2..8; 32-40 bf16 layers carry a rounding
# difference of layer 0 forward
APPLY_TOL = dict(atol=0.1, rtol=0.05)


def argmax_check(got, want, tol) -> str:
    """Argmax equal at every position where ``want``'s top-1 margin exceeds
    what the tolerance allows a difference to close; -> a summary."""
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    lim = 2 * (tol['atol'] + tol['rtol'] * top2[:, 0].abs())
    same = got.argmax(-1) == want.argmax(-1)
    decided = margin > lim
    assert bool(same[decided].all()), \
        f'argmax differs where the margin exceeds the tolerance: ' \
        f'{(~same & decided).nonzero().flatten().tolist()}'
    return (f'argmax equal at {int(same.sum())}/{len(same)} positions '
            f'(required at the {int(decided.sum())} whose top-1 margin '
            f'exceeds 2x the tolerance)')


# MoE logits of two bf16 runs that differ in rounding: a token whose router
# scores two experts within a rounding step of each other may take another
# expert in one run, and its logits then move by more than APPLY_TOL; such
# ties are rare, so at least this share of the positions must agree
MOE_AGREE = 0.5


def logits_check(cfg, got, want) -> str:
    """``got`` against ``want`` (positions x vocabulary) within
    APPLY_TOL; for an MoE config only at MOE_AGREE of the positions (the
    rest reported), with the argmax held at the agreeing positions. ->
    the summary line's tail."""
    if not cfg.moe:
        torch.testing.assert_close(got, want, **APPLY_TOL)
        return argmax_check(got, want, APPLY_TOL)
    lim = APPLY_TOL['atol'] + APPLY_TOL['rtol'] * want.abs()
    ok = ((got - want).abs() <= lim).all(dim=-1)
    share = ok.float().mean().item()
    assert share >= MOE_AGREE, \
        f'{cfg.name}: {share:.3f} of the positions within {APPLY_TOL}'
    text = argmax_check(got[ok], want[ok], APPLY_TOL) if ok.any() else ''
    return (f'MoE: {int(ok.sum())}/{len(ok)} positions within the '
            f'tolerance (at least {MOE_AGREE} required; the others hold a '
            f'routing tie), at those {text}')


def diff_text(got, want) -> str:
    dd = (got - want).abs()
    return (f'max |diff| {dd.max().item():.4g}, mean |diff| '
            f'{dd.mean().item():.3g}, max |logit| {want.abs().max().item():.3g}')


# the device kernels of an rmsnorm_matmul call, by name (the tiled
# kernels carry the wrapper's name; the wgmma and split-K forms are the row
# kernel, the GEMM or the partial products, and the combine)
RMS_KERNELS = ('rmsnorm_matmul', 'rms_rows', 'gemm_hilo', 'splitk_partial',
               'splitk_combine')


def profile_apply(fn) -> str:
    """Device ms by kernel group over one forward (torch.profiler, device
    activity only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {'flash_attention': 0.0, 'rmsnorm_matmul': 0.0,
              'matmul': 0.0, 'other': 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU or not e.self_device_time_total:
            continue
        key = e.key
        name = ('flash_attention' if 'flash_' in key else
                'rmsnorm_matmul' if any(k in key for k in RMS_KERNELS) else
                'matmul' if ('gemm' in key.lower() or 'cutlass' in key
                             or 'nvjet' in key) else 'other')
        groups[name] += e.self_device_time_total / 1e3
    return json.dumps({k: round(v, 2) for k, v in groups.items()})


def phase_apply(model, params, table, S: int, tag: str) -> dict:
    """Model.apply at full width, B 1 and S tokens, baseline and with the
    table: launch counts per forward (flash_attention once a layer,
    rmsnorm_matmul once a layer without the table and once less with it,
    embed_gather once with the table, no other kernel), ms per forward in
    turns, the last 64 positions' logits of the two against each other,
    and the precomputed forward's against the engine's chunked decode
    (score) of the same prompt. A VLM's S positions are ``VLM_PREFIX``
    text tokens, its patches (seeded) and the rest of the text; its table
    is the hybrid one (text rows gathered, the patches' layer 0 on the
    fly); its engine serves text only, so the score comparison gives way
    to :func:`check_layer0_hybrid`. An encoder-decoder's forward is the
    encoder over its frames (seeded) and the decoder over S tokens, whose
    attention is plain torch ops (no flash_attention); all S positions'
    logits are compared, and its engine serves one token a step over zero
    cross K/V, so there is no score comparison. -> launches by run."""
    cfg = model.cfg
    nl = cfg.num_layers
    audio = cfg.arch_class == 'audio'
    vlm = cfg.arch_class == 'vlm'
    # a layer's LN1 + Q/K/V is one rmsnorm_matmul launch with RMSNorm; a
    # LayerNorm model (pythia-6.9b) runs them as torch ops: no launch; MLA
    # (deepseek) runs LN1, its latents and mla_full as torch ops, as JAX
    rms = nl if cfg.norm == 'rmsnorm' and not cfg.mla else 0
    flash = 0 if audio or cfg.mla else nl
    n_cmp = S if audio else 64
    P = cfg.encoder.source_len if vlm else 0
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(3, cfg.vocab_size, size=S - P).astype(np.int32)
    batch = {'tokens': torch.from_numpy(prompt)[None].to('cuda')}
    if vlm or audio:
        e = cfg.encoder
        gen = torch.Generator(device='cuda')
        gen.manual_seed(SEED + 7)
        batch['patches' if vlm else 'frames'] = torch.randn(
            (1, e.source_len, e.frontend_dim), generator=gen,
            device='cuda').to(torch.bfloat16)
    last, launches, aux_of = {}, {}, {}
    times = {'baseline': [], 'precomputed': []}
    order = ('baseline', 'precomputed', 'baseline', 'precomputed',
             'precomputed', 'baseline')
    for i, mode in enumerate(order):
        pre = table if mode == 'precomputed' else None
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        logits, aux = model.apply(params, batch, precomputed=pre)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        ln = read_launches()
        assert ln['flash_attention'] == flash, (mode, ln)
        assert ln['rmsnorm_matmul'] == (rms if pre is None or not rms
                                        else rms - 1), (mode, ln)
        assert ln['embed_gather'] == (pre is not None), (mode, ln)
        assert all(v == 0 for k, v in ln.items() if k not in (
            'flash_attention', 'rmsnorm_matmul', 'embed_gather')), (mode, ln)
        if i < 2:                    # first of each: checks, not timed
            assert logits.shape == (1, S, cfg.vocab_size), logits.shape
            assert bool(torch.isfinite(logits).all()), f'{mode} logits'
            # the MoE load-balance loss, summed over the MoE layers; a
            # parallel MoE's table holds layer 0's MoE, so its loss drops
            assert aux.dtype == torch.float32 and aux.shape == ()
            assert (float(aux) > 0 and math.isfinite(float(aux))) \
                if cfg.moe else float(aux) == 0.0, (mode, float(aux))
            aux_of[mode] = float(aux)
            last[mode] = logits[0, -n_cmp:].float()
            launches[f'{tag}_apply' + ('_pre' if pre is not None else '')] \
                = ln
        else:
            times[mode].append(dt)
        del logits
    mean = {m: float(np.mean(t)) for m, t in times.items()}
    spread = max(max(t) - min(t) for t in times.values())
    diff = mean['baseline'] - mean['precomputed']
    layout = f' ({VLM_PREFIX} text + {P} patches + {S - P - VLM_PREFIX} ' \
        'text; the hybrid table)' if vlm else \
        f' (decoder; the encoder over {cfg.encoder.source_len} frames)' \
        if audio else ''
    log(f'[apply] {cfg.name} B=1 S={S}{layout}: ms per forward baseline '
        f'{[round(t, 2) for t in times["baseline"]]} (mean '
        f'{mean["baseline"]:.2f}), precomputed '
        f'{[round(t, 2) for t in times["precomputed"]]} (mean '
        f'{mean["precomputed"]:.2f}); baseline - precomputed {diff:.2f} ms, '
        f'{"inside" if abs(diff) <= spread else "outside"} the largest '
        f'spread between forwards of one mode ({spread:.2f} ms); launches a '
        f'forward: flash_attention {flash}, rmsnorm_matmul {rms} baseline / '
        f'{max(rms - 1, 0)} precomputed')
    base, pre = last['baseline'], last['precomputed']
    if cfg.moe:
        log(f'[apply] {cfg.name} MoE load-balance loss baseline '
            f'{aux_of["baseline"]:.6f}, precomputed '
            f'{aux_of["precomputed"]:.6f}'
            + (' (layer 0\'s MoE is in the table)'
               if cfg.block_type == 'parallel' else ''))
    log(f'[apply] {cfg.name} last {n_cmp} positions, precomputed vs '
        f'baseline logits: {diff_text(pre, base)} (tol {APPLY_TOL}); '
        + logits_check(cfg, pre, base))
    log(f'[apply] {cfg.name} baseline forward, device ms by group: '
        + profile_apply(lambda: model.apply(params, batch)))
    free()
    if vlm:
        check_layer0_hybrid(model, params, table, batch)
    if vlm or audio:
        return launches
    # an MoE's capacity comes from the tokens of one dispatch: one chunk of
    # all S tokens gives the forward's, so the two route and drop alike
    chunk = S if cfg.moe else 256
    eng = ServingEngine(model, params, max_slots=1, max_seq=S + 16,
                        precomputed=table, seed=SEED, dtype=torch.bfloat16,
                        chunk_size=chunk, fused_gather_rope=True,
                        attn_backend='cuda', device='cuda')
    t0 = time.perf_counter()
    scored = torch.from_numpy(eng.score([prompt])[0][-64:]).to('cuda')
    dt = time.perf_counter() - t0
    log(f'[apply] {cfg.name} engine chunked decode (chunk {chunk}, cuda '
        f'backend, the table with fused gather-RoPE) of the same prompt in '
        f'{dt:.2f}s ({eng.steps} steps'
        + (f', MoE token drops {eng.moe_token_drops}' if cfg.moe else '')
        + f'); last position vs the precomputed forward: '
        f'{diff_text(scored[-1:], pre[-1:])}; last 64: '
        f'{diff_text(scored, pre)} (tol {APPLY_TOL}); '
        + logits_check(cfg, scored, pre))
    del eng
    free()
    return launches


def check_layer0_hybrid(model, params, table, batch) -> None:
    """A VLM's layer 0 alone over one ``Model.apply`` sequence (``batch``:
    B 1, ``VLM_PREFIX`` text tokens, the patches, the rest of the text):
    the baseline (the embedding rows of the text and the projected patches
    spliced, then rmsnorm_matmul over [Wq|Wk|Wv]: one launch) against the
    hybrid table (``hybrid_vlm_pre0``: embed_gather of the text tokens'
    rows, LN1 + Q/K/V of the patches as torch ops, the pieces spliced).
    The projector runs once, outside both. q, k and v of the two within
    RMS_TOL; timed as CUDA-graph replays beside the bound of each."""
    cfg = model.cfg
    lay0 = params['backbone']['layer0']
    ws = [lay0['attn'][nm]['w'] for nm in ('wq', 'wk', 'wv')]
    scale = lay0['ln1']['scale']
    tokens = batch['tokens']
    vis_h = project_patches(params, batch['patches'], cfg)
    S_text, P = tokens.shape[1], vis_h.shape[1]
    n = VLM_PREFIX

    def baseline():
        txt = params['embed']['table'][tokens.long()]
        x = torch.cat([txt[:, :n], vis_h, txt[:, n:]], dim=1)
        return rmsnorm_qkv(x, scale, *ws)

    def hybrid():
        pre = hybrid_vlm_pre0(params, cfg, table, tokens, vis_h, n)
        return pre['q'], pre['k'], pre['v']
    zero_launches()
    want = baseline()
    assert read_launches()['rmsnorm_matmul'] == 1
    zero_launches()
    got = hybrid()
    ln = read_launches()
    assert ln['embed_gather'] == 1 and ln['rmsnorm_matmul'] == 0, ln
    torch.cuda.synchronize()
    err = used = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=RMS_TOL,
                                   rtol=RMS_TOL)
        dd = (g.float() - w.float()).abs()
        err = max(err, dd.max().item())
        used = max(used, (dd / (RMS_TOL + RMS_TOL * w.float().abs()))
                   .max().item())
    base_ms, hyb_ms = (time_ms(f, 3, 3) for f in (baseline, hybrid))
    es, d = 2, cfg.d_model
    W = sum(w.shape[1] for w in ws)
    b_base, _ = bound((S_text + P) * d * es + d * W * es
                      + (S_text + P) * W * es, 2 * (S_text + P) * d * W,
                      torch.bfloat16)
    b_hyb, _ = bound(S_text * table.table.shape[1] * es * 2 + P * d * es
                     + d * W * es + P * W * es, 2 * P * d * W,
                     torch.bfloat16)
    log(f'[layer0] {cfg.name} hybrid, B=1 S={S_text + P} ({n} text + {P} '
        f'patches + {S_text - n} text; text fraction '
        f'{S_text / (S_text + P):.4f}): baseline (embedding rows and the '
        f'projected patches + rmsnorm_matmul) {base_ms:.4f} ms (bound '
        f'{b_base:.4f}); hybrid (embed_gather of {S_text} text rows + LN1 '
        f'and Q/K/V of {P} patches as torch ops) {hyb_ms:.4f} ms (bound '
        f'{b_hyb:.4f}); baseline / hybrid {base_ms / hyb_ms:.2f}x; q, k, v '
        f'max |diff| {err:.3g}, at most {used:.3f} of the limit atol + '
        f'rtol |want| (atol = rtol = {RMS_TOL})')


# ---------------------------------------------------------------- phase 11
# whisper-tiny(-rope) at full width and depth: 4 requests of 1500 frames,
# 64 greedy steps from BOS over self caches of the decoder's 448 positions
WHISPER_B, WHISPER_STEPS, WHISPER_SEQ, WHISPER_BOS = 4, 64, 448, 1


def whisper_setup(arch, tag):
    """``arch``'s weights (seeded random bf16) and table (None where the
    config refuses one: printed why), seeded frames for WHISPER_B requests,
    the encoder's output (device ms of ``encoder_apply`` by CUDA events,
    after a warm run) and the cross K/V (``prefill_cross_cache``)."""
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    table = None
    if cfg.precompute_supported:
        table = model.build_table(params)
    else:
        try:
            model.build_table(params)
        except AssertionError as err:
            log(f'[{tag}] build_table refused: {err}')
        else:
            raise AssertionError(f'{cfg.name}: build_table did not refuse')
    e = cfg.encoder
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED + 11)
    frames = torch.randn((WHISPER_B, e.source_len, e.frontend_dim),
                         generator=gen, device='cuda').to(torch.bfloat16)
    E.encoder_apply(params['encoder'], frames, cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    enc = E.encoder_apply(params['encoder'], frames, cfg)
    end.record()
    xkv = E.prefill_cross_cache(params, enc, cfg)
    torch.cuda.synchronize()
    assert enc.shape == (WHISPER_B, e.source_len, e.d_model) \
        and bool(torch.isfinite(enc).all()), enc.shape
    log(f'[{tag}] {cfg.name}: encoder {e.num_layers} x d {e.d_model} '
        f'({e.num_heads} heads, sinusoidal positions), decoder '
        f'{cfg.num_layers} x d {cfg.d_model} ({cfg.num_heads}H/'
        f'{cfg.num_kv_heads}KV x {cfg.head_dim}, positions {cfg.pos}, '
        f'cross-attention), tied head, vocab {cfg.vocab_size}; weights '
        f'{tree_bytes(params) / 2**20:.1f} MiB'
        + ('' if table is None else
           f' + table {tuple(table.table.shape)} '
           f'({nbytes(table.table) / 2**20:.1f} MiB, layout '
           f'{table.layout})')
        + f'; encoder_apply B={WHISPER_B} x {e.source_len} frames: '
        f'{start.elapsed_time(end):.3f} ms, finite; cross K/V '
        f'{sum(nbytes(*kv) for kv in cross_pairs(xkv)) / 2**20:.2f} MiB')
    return cfg, model, params, table, xkv


def cross_pairs(xkv):
    """The (k, v) pairs of ``prefill_cross_cache``'s output."""
    return [xkv['layer0']] + list(xkv.get('body', [])) \
        + list(xkv.get('tail', []))


def whisper_states(model, xkv, B):
    """Fresh decode states for B requests (B <= WHISPER_B: the first B
    requests' cross K/V), the cross K/V copied in."""
    st = model.make_states(B, WHISPER_SEQ, torch.bfloat16, device='cuda')
    part = {k: ([tuple(x[:, :B] for x in v[0])] if k == 'body' else
                [tuple(x[:B] for x in kv) for kv in v] if k == 'tail' else
                tuple(x[:B] for x in v)) for k, v in xkv.items()}
    return E.put_cross_cache(st, part)


def whisper_greedy(model, params, table, xkv, force=None):
    """WHISPER_STEPS decode steps from BOS for WHISPER_B requests through
    ``Model.decode_step`` (eager; the attend on the reference backend, as
    'auto' resolves for audio), greedy, or fed ``force`` (B, steps) in
    place of the greedy token. -> (logits (steps, B, V) fp32, greedy
    tokens (B, steps), launches, host ms a step)."""
    B = WHISPER_B
    st = whisper_states(model, xkv, B)
    tok = torch.full((B, 1), WHISPER_BOS, dtype=torch.int32, device='cuda')
    logits, toks = [], []
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for i in range(WHISPER_STEPS):
        pos = torch.full((B,), i, dtype=torch.int32, device='cuda')
        lg, st = model.decode_step(params, tok, st, pos, precomputed=table)
        logits.append(lg[:, 0].float())
        nxt = lg[:, 0].argmax(-1).to(torch.int32)
        toks.append(nxt)
        tok = (nxt if force is None else force[:, i])[:, None].contiguous()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / WHISPER_STEPS
    launches = read_launches()
    lg = torch.stack(logits)
    assert lg.shape == (WHISPER_STEPS, B, model.cfg.vocab_size) \
        and bool(torch.isfinite(lg).all())
    assert launches['embed_gather'] == (WHISPER_STEPS if table is not None
                                        else 0), launches
    assert all(v == 0 for k, v in launches.items() if k != 'embed_gather'), \
        launches
    return lg, torch.stack(toks, dim=1), launches, ms


def decode_step_bytes(model, params, table, B, pos) -> int:
    """Bytes one decode step at position ``pos`` must read: every decoder
    weight but the cross-attention's wk / wv (their K/V come precomputed)
    and, with the table, layer 0's wq / wk / wv (B table rows instead),
    the tied head, the final norm, B requests' cross K/V, and of their
    self caches the pos valid entries read and the new one written (the
    reference reads all WHISPER_SEQ; the rest are masked, so the function
    needs none of them)."""
    cfg = model.cfg
    skip = {'wk', 'wv'}

    def layer_bytes(p, first):
        n = 0
        for nm, sub in p.items():
            if nm == 'xattn':
                n += sum(nbytes(v['w']) for k, v in sub.items()
                         if k not in skip)
            elif first and table is not None and nm in ('ln1', 'attn'):
                n += nbytes(sub['wo']['w']) if nm == 'attn' else 0
            else:
                n += tree_bytes(sub)
        return n
    bp = params['backbone']
    total = layer_bytes(bp['layer0'], True) \
        + sum(layer_bytes(p, False) for p in bp.get('tail', []))
    if 'body' in bp:
        total += layer_bytes(bp['body'][0], False)
    total += tree_bytes(params['embed']) + tree_bytes(params['final_norm'])
    if table is not None:
        total += B * table.table.shape[1] * 2
    else:
        total += B * cfg.d_model * 2 * (2 if cfg.pos == 'learned' else 1)
    kvb = cfg.num_kv_heads * cfg.head_dim * 2
    total += cfg.num_layers * B * (cfg.encoder.source_len * 2 * kvb
                                   + (pos + 1) * (2 * kvb + 4))
    return total


def whisper_step_times(tag, model, params, table, xkv) -> None:
    """Device ms of one ``Model.decode_step`` at B 1 and 4, baseline and
    (where there is one) with the table, in turns (baseline, table, table,
    baseline): 20 steps captured in a CUDA graph and replayed (``time_ms``;
    an eager step is bound by its host's launches, which would hide the
    table), the device kernels of a step (a capture's nodes), and the
    bound of the bytes a step must read."""
    modes = (('baseline', None),) + ((('table', table),) if table is not None
                                     else ())
    for B in (1, WHISPER_B):
        steps = {}
        for mode, tab in modes:
            st = whisper_states(model, xkv, B)
            tok = torch.full((B, 1), WHISPER_BOS, dtype=torch.int32,
                             device='cuda')
            pos = torch.full((B,), WHISPER_STEPS, dtype=torch.int32,
                             device='cuda')
            steps[mode] = (lambda st=st, tok=tok, pos=pos, tab=tab:
                           model.decode_step(params, tok, st, pos,
                                             precomputed=tab))
        times = {mode: [] for mode in steps}
        for mode in (list(steps) + list(steps)[::-1]):
            times[mode].append(time_ms(steps[mode]))
        for mode, tab in modes:
            nb = decode_step_bytes(model, params, tab, B, WHISPER_STEPS)
            b_ms, by = bound(nb, 0, torch.bfloat16)
            log(f'[{tag}_step] B={B} {mode}: '
                f'{[round(t, 4) for t in times[mode]]} device ms a decode '
                f'step (CUDA-graph replays of Model.decode_step, in turns), '
                f'{device_kernels(steps[mode])} device kernels a step, bound '
                f'{b_ms:.4f} ms ({by}: {nb / 1e6:.2f} MB)')
        if table is not None:
            base, pre = (float(np.mean(times[m])) for m in ('baseline',
                                                            'table'))
            spread = max(max(t) - min(t) for t in times.values())
            nl = model.cfg.num_layers
            log(f'[{tag}_step] B={B}: the table saves {base - pre:.4f} ms '
                f'of {base:.4f} ({(base - pre) / base:.1%}; the largest '
                f'spread of one mode {spread:.4f} ms; the paper\'s bound for '
                f'{nl} layers: {1 / nl:.0%})')
        del steps


def whisper_engine(tag, model, params, table) -> dict:
    """The engine serving WHISPER_B requests as JAX's engine serves audio:
    the reference backend ('auto'), chunk 1, dense caches, every slot's
    cross K/V zero (the engine runs no encoder), the table; prompts of
    8-24 tokens from BOS, 32 new tokens each, after a warm-up request.
    -> launches (embed_gather once a step)."""
    cfg = model.cfg
    eng = ServingEngine(model, params, max_slots=WHISPER_B,
                        max_seq=WHISPER_SEQ, precomputed=table, seed=SEED,
                        dtype=torch.bfloat16, device='cuda')
    assert eng.attn_backend.name == 'reference' and eng.chunk_size == 1 \
        and not eng.paged and not eng._graphs
    rng = np.random.default_rng(SEED + 13)

    def prompt(n):
        return np.concatenate([[WHISPER_BOS], rng.integers(
            3, cfg.vocab_size, size=n - 1)]).astype(np.int32)
    eng.submit(Request(uid=100, prompt=prompt(8), max_new_tokens=2))
    eng.run()
    reqs = [Request(uid=i, prompt=prompt(int(rng.integers(8, 25))),
                    max_new_tokens=32) for i in range(WHISPER_B)]
    torch.cuda.synchronize()
    steps0 = eng.steps
    zero_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    steps = eng.steps - steps0
    for r in reqs:
        assert r.status is RequestStatus.FINISHED and \
            len(r.generated) == 32, (r.uid, r.status, r.error)
    assert launches['embed_gather'] == (steps if table is not None else 0) \
        and all(v == 0 for k, v in launches.items()
                if k != 'embed_gather'), launches
    stats = eng.stats(reqs)
    log(f'[{tag}_engine] {WHISPER_B} requests (prompts '
        f'{[len(r.prompt) for r in reqs]}, zero cross K/V, reference '
        f'backend, chunk 1, eager steps), {stats["tokens"]} new tokens in '
        f'{dt:.3f}s -> {stats["tokens"] / dt:.1f} tok/s; {steps} steps '
        f'({dt / steps * 1e3:.2f} ms/step); mean TTFT '
        f'{stats["mean_ttft_s"]:.3f}s; launches {json.dumps(launches)}')
    return launches


def phase_whisper(rows) -> dict:
    """whisper-tiny-rope (the paper's 4-layer example) and whisper-tiny (its
    learned positions refuse the table) at full width and depth on seeded
    random bf16 weights, following ``examples/whisper_decode.py``: the
    encoder over 4 x 1500 seeded frames, the cross K/V, 64 greedy decode
    steps from BOS (whisper-tiny-rope with and without the table: the
    table's run fed the baseline's tokens, logits within APPLY_TOL and
    argmax equal where the margin decides; its own greedy run's tokens
    equal to the baseline's), the decode step's device time as CUDA-graph
    replays at B 1 and 4 in turns, ``Model.apply`` in turns and the
    engine serving 4 requests. -> launches by run."""
    out = {}
    cfg, model, params, table, xkv = whisper_setup('whisper_tiny_rope',
                                                   'whisper_rope')
    base, btok, out['whisper_rope_base'], bms = whisper_greedy(
        model, params, None, xkv)
    forced, _, out['whisper_rope'], pms = whisper_greedy(
        model, params, table, xkv, force=btok)
    _, ptok, _, _ = whisper_greedy(model, params, table, xkv)
    flat = (forced.reshape(-1, cfg.vocab_size),
            base.reshape(-1, cfg.vocab_size))
    torch.testing.assert_close(*flat, **APPLY_TOL)
    same = int((ptok == btok).sum())
    assert same == btok.numel(), \
        f'whisper-tiny-rope: the table\'s greedy tokens differ ({same} of ' \
        f'{btok.numel()} equal)'
    log(f'[whisper_rope] {WHISPER_STEPS} greedy steps x {WHISPER_B} '
        f'requests from BOS over the cross K/V: baseline {bms:.3f} host ms '
        f'a step (eager), with the table {pms:.3f}; the table fed the '
        f'baseline\'s tokens: {diff_text(*flat)} (tol {APPLY_TOL}); '
        + argmax_check(*flat, APPLY_TOL)
        + f'; the table\'s own greedy tokens equal to the baseline\'s: '
        f'{same}/{btok.numel()} (asserted); launches with the table '
        f'{json.dumps(out["whisper_rope"])} (one embed_gather a step)')
    whisper_step_times('whisper_rope', model, params, table, xkv)
    out.update(phase_apply(model, params, table, WHISPER_SEQ,
                           'whisper_rope'))
    out['whisper_rope_engine'] = whisper_engine('whisper_rope', model,
                                                params, table)
    del model, params, table, xkv
    free()
    cfg, model, params, table, xkv = whisper_setup('whisper_tiny',
                                                   'whisper_tiny')
    assert table is None
    _, tok, out['whisper_tiny'], ms = whisper_greedy(model, params, None,
                                                     xkv)
    log(f'[whisper_tiny] {WHISPER_STEPS} greedy steps x {WHISPER_B} requests '
        f'(learned positions added to the embedding rows a step, no table): '
        f'{ms:.3f} host ms a step (eager), finite logits, greedy tokens of '
        f'request 0: {tok[0, :16].tolist()}...')
    whisper_step_times('whisper_tiny', model, params, None, xkv)
    del model, params, xkv
    free()
    return out


# ----------------------------------------------------------------- phase 4
def phase_mistral(rows) -> dict:
    """mistral-7b on dense ring caches, in bf16 with the table, without it
    (the baseline: embedding read and layer 0's norm and projections at
    run time) and with int8 KV caches, on the same weights and requests;
    then, on the same weights, through the paged pool with ring pages
    (:func:`phase_mistral_paged`), the layer-0 comparison and Model.apply
    at S 8192."""
    cfg = cut_config('mistral_7b')
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    table = model.build_table(params)
    torch.cuda.synchronize()
    log(f'[engine] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, '
        f'weights + table made on the card in '
        f'{time.perf_counter() - t0:.1f}s; table {tuple(table.table.shape)} '
        f'{str(table.table.dtype)[6:]}')
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        64, 201))).astype(np.int32) for _ in range(4)]
    out = {}
    for run, tab, kv_quant in (('mistral', table, False),
                               ('mistral_baseline', None, False),
                               ('mistral_int8', table, True)):
        # bf16 and int8: an eager twin first, the replays held against it
        want = None if tab is None else serve_dense(
            model, params, tab, prompts, rng, kv_quant, eager=True)[3]
        out[run] = serve_dense(model, params, tab, prompts, rng, kv_quant,
                               expect=want)
        del want
        free()
    (base, bytes16), (tok8, bytes8) = out['mistral'][1:3], \
        out['mistral_int8'][1:3]
    log(f'[engine int8] KV cache bytes {bytes8} int8 against {bytes16} bf16 '
        f'({bytes8 / bytes16:.3f}); greedy tokens equal to the bf16 run\'s: '
        f'{token_share(tok8, base)} (reported, not checked)')
    log(f'[engine baseline] greedy tokens equal to the precomputed run\'s: '
        f'{token_share(out["mistral_baseline"][1], base)} (reported, not '
        'checked)')
    phases = {run: v[0] for run, v in out.items()}
    phases.update(phase_mistral_paged(model, params, table))
    check_layer0(model, params, table, LAYER0_COUNTS + (8192,), rows)
    phases.update(phase_apply(model, params, table, 8192, 'mistral'))
    return phases


def phase_mistral_paged(model, params, table, device='cuda',
                        lengths=(4160, 4401)) -> dict:
    """mistral-7b through the paged pool and the radix cache on phase 4's
    weights and table: ring pages with snapshots (page 16, max_seq 4608,
    chunk 16: Sc 4111, 257 ring pages a slot, the default pool), a
    two-turn chat (:func:`serve_ring`) in bf16 and then with an int8 pool.
    Logs the phase's own seconds. -> launches by run."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    cfg = model.cfg
    prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        *lengths))).astype(np.int32) for _ in range(RING_SLOTS)]
    out = {}
    on_card = torch.device(device).type == 'cuda'
    for run, kv_quant in (('mistral_paged', False),
                          ('mistral_paged_int8', True)):
        # bf16 on the card: an eager twin first, the replays held against it
        want = serve_ring(model, params, table, prompts, run, kv_quant,
                          device, eager=True)[2] \
            if on_card and not kv_quant else None
        out[run] = serve_ring(model, params, table, prompts, run, kv_quant,
                              device, expect=want)
        del want
        if on_card:
            free()
        if not kv_quant:
            # the async loop through the snapshot hits: the synchronous
            # run's tokens
            run = 'mistral_paged_async'
            out[run] = serve_ring(model, params, table, prompts, run, False,
                                  device, async_loop=True)
            assert out[run][1] == out['mistral_paged'][1], \
                f'{run}: greedy tokens differ from [mistral_paged]'
            log(f'[{run}] greedy tokens ({sum(map(len, out[run][1]))}) '
                'equal to [mistral_paged]\'s')
            if on_card:
                free()
    log(f'[mistral_paged_int8] greedy tokens equal to the bf16 run\'s: '
        f'{token_share(out["mistral_paged_int8"][1], out["mistral_paged"][1])}'
        f' (reported, not checked); phase seconds (both runs) '
        f'{time.perf_counter() - t0:.1f}')
    return {run: v[0] for run, v in out.items()}


def snapshots_held(eng) -> tuple:
    """(snapshots on the radix index, their bytes)."""
    n, size, stack = 0, 0, [eng.kv.root]
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.snapshot is not None:
            n += 1
            size += nbytes(*node.snapshot)
    return n, size


def timed_calls(eng, name, events) -> None:
    """Record CUDA events around each call of the engine method ``name``
    (the instance's attribute shadows the method)."""
    fn = getattr(eng, name)

    def run(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        events.append((start, end))
        return out
    setattr(eng, name, run)


def calls_ms(fn, reps: int = 5) -> float:
    """Device ms a call of ``fn`` between CUDA events over ``reps`` calls
    after one warm-up call; each result is dropped before the next call,
    so the allocator reuses its blocks."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serve_ring(model, params, table, prompts, tag, kv_quant, device,
               eager: bool = False, expect=None, async_loop: bool = False,
               max_seq: int = RING_SEQ, num_pages=None, pre_waves=()):
    """One paged engine (ring pages with snapshots; with global layers in
    the pattern also linear pages) over a two-turn chat, 16 new tokens a
    request. With ``pre_waves`` (two lists of requests on one system prompt
    of ``GEMMA_SYSTEM`` tokens, the first of whose wave publishes its
    snapshot at the system prompt's end: :func:`gemma_traffic`), those
    waves first: the first misses, every request of the second hits the
    whole system prompt, and each FINISHED with its tokens. Wave 1:
    ``prompts`` (every ring wraps in its
    prefill; each publishes a snapshot at ((P - 1) // 16) * 16). Wave 2:
    each prompt + its 16 greedy tokens + 32 new tokens, a prefix hit at
    that snapshot and a restore. Then ``score()`` of the first prompt's
    first 200 tokens and a profiled batch of four more second turns.
    Checks the launch counts (attention and fused_page_write once a layer
    and a step, one gather a step, cow_page_copy never), the hit tokens and
    that every request FINISHED with 16 tokens. ``eager`` / ``expect`` as
    in :func:`serve_dense` (an eager run also skips the snapshot timings).
    ``async_loop``: the engine runs the async double-buffered loop (no
    timings, no profile) and the flushes at snapshot boundaries (a pending
    lane's commit captures the ring before the slot's next chunk) are
    counted and printed. ``max_seq`` and ``num_pages`` (None: the
    engine's default pool) size the engine. -> (launches, greedy tokens of
    the pre-waves and both chat waves, digest)."""
    cfg = model.cfg
    on_card = torch.device(device).type == 'cuda'
    attn = 'paged_attention_quant' if kv_quant else 'paged_attention'
    rng = np.random.default_rng(SEED + 5)
    eng = ServingEngine(model, params, max_slots=RING_SLOTS, max_seq=max_seq,
                        num_pages=num_pages, precomputed=table, seed=SEED,
                        dtype=next(iter(params['embed'].values())).dtype,
                        chunk_size=16, fused_gather_rope=True,
                        prefix_cache=True, page_size=RING_PS,
                        kv_quant=kv_quant, attn_backend='cuda',
                        async_loop=async_loop, device=device)
    assert eng.paged and eng.fused_gather_rope == (table is not None) \
        and eng._fused_maint and eng._needs_snapshot \
        and bool(eng._lin_layers) == ('global' in cfg.pattern)
    flushes = []
    if async_loop:
        flush = eng._flush_async

        def counted():
            flushes.append(eng._pending is not None
                           and eng._pending.needs_sync)
            flush()
        eng._flush_async = counted
    if cfg.window == get_config('mistral_7b').window:
        assert (eng._sc_ring, eng._pages_ring, eng.num_pages) == \
            ring_geometry(), (eng._sc_ring, eng._pages_ring, eng.num_pages)
    log(f'[{tag}] paged pool with ring pages: {eng.num_pages} pages x '
        f'{eng.page_size} tokens x {cfg.num_layers} layers; Sc '
        f'{eng._sc_ring}, {eng._pages_ring} ring pages and '
        f'{eng._pages_lin} linear pages a slot; leaves '
        f'{sorted(eng.states["layer0"])}; pool bytes '
        f'{nbytes(*[x for pool, _ in eng._pools for x in pool.values()])}')
    if eager:
        tag += ' eager'
    warm = rng.integers(3, cfg.vocab_size, size=40).astype(np.int32)
    captures, restores = [], []
    flushes0 = 0
    first = [Request(uid=i, prompt=p, max_new_tokens=16)
             for i, p in enumerate(prompts)]
    second = []
    pre = [[Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in w]
           for w in pre_waves]
    with steps_mode(eager):
        eng.submit(Request(uid=100, prompt=warm, max_new_tokens=2))
        eng.run()
        timing = on_card and not eager and not async_loop
        flushes0 = sum(flushes)
        if timing:
            timed_calls(eng, '_capture', captures)
            timed_calls(eng, '_restore', restores)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        steps0, drops0 = eng.steps, eng.moe_token_drops
        zero_launches()
        spans = program_spans() if on_card else contextlib.nullcontext([])
        with spans as events:
            waves, t_all = [], time.perf_counter()
            for reqs in pre:
                t0 = time.perf_counter()
                for r in reqs:
                    eng.submit(r)
                eng.run()
                if on_card:
                    torch.cuda.synchronize()
                waves.append(time.perf_counter() - t0)
            snaps0 = snapshots_held(eng)[0]
            for wave in range(2):
                reqs = first if wave == 0 else second
                t0 = time.perf_counter()
                for r in reqs:
                    eng.submit(r)
                eng.run()
                if on_card:
                    torch.cuda.synchronize()
                waves.append(time.perf_counter() - t0)
                if wave == 0:
                    assert snapshots_held(eng)[0] == snaps0 + len(first)
                    second = [Request(uid=10 + i, prompt=np.concatenate(
                        [r.prompt, np.asarray(r.generated, np.int32),
                         rng.integers(3, cfg.vocab_size, size=32).astype(
                             np.int32)]), max_new_tokens=16)
                        for i, r in enumerate(first)]
            dt = time.perf_counter() - t_all
    launches = read_launches()
    steps = eng.steps - steps0
    pre = [r for w in pre for r in w]
    for r in pre + first + second:
        assert r.status is RequestStatus.FINISHED, (r.uid, r.status, r.error)
        assert len(r.generated) == r.max_new_tokens, (r.uid,
                                                      len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    reqs = pre + first + second
    hits = [((len(p) - 1) // RING_PS) * RING_PS for p in prompts]
    pre_hits = [r.prefix_hit_tokens for r in pre]
    if pre_waves:
        assert pre_hits == [0] * len(pre_waves[0]) + [GEMMA_SYSTEM] * len(
            pre_waves[1]), pre_hits
    assert [r.prefix_hit_tokens for r in first] == [0] * len(first)
    assert [r.prefix_hit_tokens for r in second] == hits, \
        ([r.prefix_hit_tokens for r in second], hits)
    stats = eng.stats(reqs)
    assert stats['cow_copies'] == 0 and launches['cow_page_copy'] == 0, \
        launches
    for name in (attn, 'fused_page_write'):     # wrappers count on the card
        assert not on_card or launches[name] == cfg.num_layers * steps, \
            (name, launches[name], steps)
    # one gather a step with the table (the fused one), none without it
    gathers = launches['gather_rope'] + launches['embed_gather']
    assert not on_card or (gathers == steps and launches['gather_rope'] > 0
                           if table is not None else gathers == 0), \
        (launches, steps)
    if kv_quant:
        assert launches['paged_attention'] == 0, launches
    ttft = [[r.first_token_t - r.submit_t for r in w]
            for w in (first, second)]
    n_snap, snap_bytes = snapshots_held(eng)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    pre_text = '' if not pre else (
        f'pre-waves {[len(w) for w in pre_waves]} requests (prompts '
        f'{[len(r.prompt) for r in pre]}, prefix hits {pre_hits}), then ')
    log(f'[{tag}] {len(reqs)} requests ({pre_text}chat wave 1 prompts '
        f'{[len(p) for p in prompts]}, wave 2 second turns '
        f'{[len(r.prompt) for r in second]}), '
        f'{stats["tokens"]} new tokens in {dt:.3f}s -> '
        f'{stats["tokens"] / dt:.1f} tok/s; {steps} steps '
        f'({dt / steps * 1e3:.2f} ms/step); wave seconds '
        f'{[round(w, 3) for w in waves]}; mean TTFT on a miss (chat wave 1) '
        f'{np.mean(ttft[0]):.3f}s, on a hit (wave 2) {np.mean(ttft[1]):.3f}s '
        f'({np.mean(ttft[0]) / np.mean(ttft[1]):.1f}x); peak memory '
        f'{peak:.2f} GiB' + ('; ' + span_text(events, dt, steps)
                             if on_card else ''))
    log(f'[{tag}] prefix hits {stats["prefix_hits"]}, misses '
        f'{stats["prefix_misses"]}, hit tokens {stats["prefix_hit_tokens"]} '
        f'(per request {[r.prefix_hit_tokens for r in reqs]}), '
        f'copy-on-write {stats["cow_copies"]}, pages in use '
        f'{stats["pages_in_use"]}, evictions {stats["evictions"]}, '
        f'preemptions {stats["preemptions"]}, MoE token drops '
        f'{eng.moe_token_drops - drops0}; snapshots held {n_snap} '
        f'({snap_bytes} bytes, {snap_bytes / max(n_snap, 1) / 2**30:.3f} GiB '
        'each)')
    if async_loop:
        n_flush = sum(flushes) - flushes0
        assert n_flush > 0, 'no pending lane landed on a snapshot boundary'
        log(f'[{tag}] async loop: {n_flush} flushes at snapshot boundaries '
            f'in the waves (a pending lane\'s commit before the slot\'s next '
            f'chunk); second turns hitting a snapshot '
            f'{sum(r.prefix_hit_tokens > 0 for r in second)} of '
            f'{len(second)}')
    tokens = [r.generated for r in reqs]
    if timing:
        for name in ('_capture', '_restore'):
            delattr(eng, name)
    with steps_mode(eager):
        scores = eng.score([prompts[0][:200]])
    digest = replay_digest(eng, tokens, scores)
    if expect is not None:
        check_replay(f'[{tag}]', eng, digest, expect)
    if on_card:
        log_programs(f'[{tag}]', eng)
    if timing:
        torch.cuda.synchronize()
        # the copies alone: a capture and a restore of free pages, repeated
        # with the allocator's blocks reused (no new device memory)
        pages = eng.kv.alloc(eng._pages_ring)
        eng.slot_ring[0] = pages
        snap = eng._capture(0)
        alone = {'capture': calls_ms(lambda: eng._capture(0)),
                 'restore': calls_ms(lambda: eng._restore(0, snap))}
        eng.slot_ring[0] = []
        eng.kv.free(pages)
        del snap
        # a snapshot's bytes read once and written once
        b_ms, by = bound(2 * snap_bytes / max(n_snap, 1), 0, torch.bfloat16)
        for what, ev in (('capture', captures), ('restore', restores)):
            ms = [a.elapsed_time(b) for a, b in ev]
            log(f'[{tag}] snapshot {what}: {len(ms)} calls in the waves, '
                f'ms between CUDA events (the device waits while the host '
                f'allocates a capture\'s memory) mean {np.mean(ms):.4f}, min '
                f'{min(ms):.4f}, max {max(ms):.4f}; the copies alone '
                f'{alone[what]:.4f} device ms; bound {b_ms:.4f} ms ({by})')
    log(f'[{tag}] launches {json.dumps(launches)} over {steps} steps '
        f'({attn} and fused_page_write {cfg.num_layers} a step, '
        f'{"one gather" if table is not None else "no gather (no table)"} '
        'a step, cow_page_copy 0); all requests FINISHED with their tokens '
        '(finite logits)')
    if timing:
        profile_engine(eng, [Request(uid=20 + i, prompt=np.concatenate(
            [r.prompt, np.asarray(r.generated, np.int32), rng.integers(
                3, cfg.vocab_size, size=32).astype(np.int32)]),
            max_new_tokens=16) for i, r in enumerate(first)])
    return launches, tokens, digest


def token_share(got, base) -> str:
    """Share of greedy tokens equal, position by position, to a run on
    the same requests."""
    same = sum(a == b for g, w in zip(got, base) for a, b in zip(g, w))
    total = sum(len(w) for w in base)
    return f'{same}/{total} = {same / total:.3f}'


def cache_bytes(eng) -> int:
    leaves = []
    for st in eng.states.values():
        for layer in (st if isinstance(st, list) else [st]):
            leaves += list(layer.values())
    return nbytes(*leaves)


def serve_dense(model, params, table, prompts, rng, kv_quant: bool,
                eager: bool = False, expect=None):
    """One engine over ``prompts`` (16 new tokens each) on dense ring
    caches, chunk 16, fused gather→RoPE, the cuda backend; int8 caches
    with ``kv_quant``; ``table`` None runs the baseline (no table, no
    gathers). Then ``score()`` of the first prompt's first 40 tokens. With
    ``eager``, every step inside ``_eager_steps()`` and no profile; with
    ``expect`` (an eager run's digest), the run's tokens, score logits and
    caches are held bitwise against it (:func:`check_replay`). ->
    (launches, greedy tokens, cache bytes, digest)."""
    cfg = model.cfg
    tag = '[engine int8]' if kv_quant else '[engine]' if table is not None \
        else '[engine baseline]'
    if eager:
        tag = tag[:-1] + ' eager]'
    attn = 'paged_attention_quant' if kv_quant else 'paged_attention'
    eng = ServingEngine(model, params, max_slots=4, max_seq=512,
                        precomputed=table, seed=SEED, dtype=torch.bfloat16,
                        chunk_size=16, fused_gather_rope=True,
                        kv_quant=kv_quant, attn_backend='cuda', device='cuda')
    assert eng.fused_gather_rope == (table is not None) \
        and eng.attn_backend.name == 'cuda' and eng._graphs
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    with steps_mode(eager):
        # warm-up request (cuBLAS handles, allocator, the step shapes'
        # graphs) outside the measured run
        warm = Request(uid=100, prompt=reqs[0].prompt[:20], max_new_tokens=2)
        eng.submit(warm)
        eng.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = eng.steps
        zero_launches()
        with program_spans() as events:
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            report = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    launches = read_launches()
    for r in reqs:
        assert r.status is RequestStatus.FINISHED, (r.uid, r.status, r.error)
        assert len(r.generated) == 16, (r.uid, len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    gathers = ('embed_gather', 'gather_rope')
    for name in (gathers if table is not None else ()) + (attn,):
        assert launches[name] > 0, f'{name} never launched on the engine path'
    if table is None:
        assert all(launches[name] == 0 for name in gathers), launches
    stats = eng.stats(reqs)
    steps = eng.steps - steps0
    assert launches[attn] == cfg.num_layers * steps, \
        (attn, launches[attn], steps)
    if table is not None:       # one gather a step: one-token or chunked
        assert sum(launches[name] for name in gathers) == steps, \
            (launches, steps)
    if kv_quant:
        assert launches['paged_attention'] == 0, launches
    log(f'{tag} 4 requests, prompts {[len(r.prompt) for r in reqs]}, '
        f'{stats["tokens"]} new tokens in {dt:.3f}s -> '
        f'{stats["tokens"] / dt:.1f} tok/s; {steps} steps '
        f'({dt / steps * 1e3:.2f} ms/step); mean TTFT '
        f'{stats["mean_ttft_s"]:.3f}s (p50 {report["p50_ttft_s"]:.3f}s); '
        f'mean latency {stats["mean_latency_s"]:.3f}s; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        + span_text(events, dt, steps))
    log(f'{tag} launches {json.dumps(launches)} over {steps} steps '
        f'({attn}: {cfg.num_layers} a step'
        + (', one gather a step' if table is not None else '')
        + '); all requests FINISHED with 16 tokens (finite logits)')
    tokens = [r.generated for r in reqs]
    with steps_mode(eager):
        scores = eng.score([prompts[0][:40]])
    digest = replay_digest(eng, tokens, scores)
    if expect is not None:
        check_replay(tag, eng, digest, expect)
    log_programs(tag, eng)
    if not eager:
        profile_engine(eng, [Request(uid=10 + i, prompt=rng.integers(
            3, cfg.vocab_size, size=int(rng.integers(64, 201))).astype(
                np.int32), max_new_tokens=16) for i in range(4)])
    return launches, tokens, cache_bytes(eng), digest


@contextlib.contextmanager
def program_spans():
    """CUDA events around every step program's run inside the block: the
    device's span of each run (a graph's replay, or an eager forward with
    the host's gaps in it), without a profiler's cost per kernel. Yields
    the list of (start, end) events."""
    events = []
    run = StepProgram.run

    def timed(prog, graphs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(prog, graphs)
        end.record()
        events.append((start, end))
        return out
    StepProgram.run = timed
    try:
        yield events
    finally:
        StepProgram.run = run


def span_text(events, wall_s: float, steps: int) -> str:
    """The programs' device span a step and the idle share outside it."""
    ms = sum(a.elapsed_time(b) for a, b in events)
    return (f'device span of the step programs {ms / steps:.3f} ms a step, '
            f'idle share outside them {1 - ms / (wall_s * 1e3):.3f}')


def steps_mode(eager: bool):
    """``_eager_steps()`` for an eager twin, else nothing: the engine's
    programs capture and replay their CUDA graphs."""
    return _eager_steps() if eager else contextlib.nullcontext()


def replay_digest(eng, tokens, scores) -> dict:
    """What a run with replayed CUDA graphs and its eager twin must share
    bit for bit: greedy tokens, ``score()`` logits and every state leaf
    (caches or pool; references, so take it before anything else writes
    the state)."""
    return dict(tokens=tokens, scores=[x.tobytes() for x in scores],
                shapes=[x.shape for x in scores],
                leaves=state_leaves(eng.states))


def check_replay(tag, eng, got, want) -> None:
    """``got`` (a run whose steps replayed CUDA graphs) against ``want``
    (the same run under ``_eager_steps()``), bitwise; every program of the
    run captured its graph and replays happened."""
    progs = list(eng.programs.values())
    assert eng._graphs and progs and all(p.graph is not None
                                         for p in progs), tag
    assert sum(p.replays for p in progs) > 0, tag
    assert got['tokens'] == want['tokens'], \
        f'{tag}: greedy tokens of the replayed run differ from the eager run'
    assert got['shapes'] == want['shapes'] \
        and got['scores'] == want['scores'], \
        f'{tag}: score logits differ from the eager run'
    assert len(got['leaves']) == len(want['leaves']), tag
    for i, (a, b) in enumerate(zip(got['leaves'], want['leaves'])):
        b = b.to(a.device)           # an eager digest may be held on the host
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)
        ), f'{tag}: state leaf {i} {tuple(a.shape)} differs from the eager run'
    log(f'{tag} replayed CUDA graphs bitwise the eager run '
        f'(_eager_steps): {sum(map(len, got["tokens"]))} greedy tokens, '
        f'score logits {[tuple(x) for x in got["shapes"]]}, '
        f'{len(got["leaves"])} state leaves '
        f'({nbytes(*got["leaves"])} bytes)')


def graph_pool_mib(eng) -> float:
    """MiB of device memory in the engine's CUDA graph pool (the
    allocator's segments of that pool); nan where the snapshot does not
    name a segment's pool."""
    if eng._graph_pool is None:
        return 0.0
    pool, total, named = tuple(eng._graph_pool), 0, True
    for seg in torch.cuda.memory_snapshot():
        if 'segment_pool_id' not in seg:
            named = False
        elif tuple(seg['segment_pool_id']) == pool:
            total += seg['total_size']
    return total / 2**20 if named else float('nan')


def log_programs(tag, eng) -> None:
    """One line on the engine's step programs: each key's capture ms and
    replays, the graph pool's MiB."""
    progs = sorted(eng.programs.items())
    log(f'{tag} step programs (path, slot bucket, T, logits): '
        + ('; '.join(f'{k} capture {p.capture_ms:.1f} ms, {p.replays} '
                     'replays' if p.graph is not None else f'{k} eager'
                     for k, p in progs))
        + f'; graph pool {graph_pool_mib(eng):.1f} MiB')


def profile_engine(eng, reqs, spans=()) -> dict:
    """Device time by kernel over a batch like the measured one
    (torch.profiler recording device activity only), the device kernels
    (and copies) a step, and the device's idle share of that window.
    -> device ms a step by group and ``kernels`` a step ({} when the
    profiler recorded no device time). With ``spans`` (names of engine
    methods), each call of them runs in a ``record_function`` range of its
    name, the host's activity is traced too (its cost falls in the
    window's wall time), and each span's device time is the sum of the
    kernels and copies launched inside it: busy time, without the gaps in
    which the stream waits for the host. CUDA events around every step
    program's run give a second measure that needs no profiler: the
    device's span of the runs (a graph's replay, or an eager forward with
    the host's gaps in it), and the idle share outside those spans. The
    nodes of each captured program (a re-capture of its forward) are the
    device kernels of a step of that shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(fn, label):
        def run(*args):
            with record_function(label):
                return fn(*args)
        return run
    for name in spans:
        setattr(eng, name, labelled(getattr(eng, name), 'engine.' + name))
    acts = [ProfilerActivity.CUDA] + \
        ([ProfilerActivity.CPU] if spans else [])
    torch.cuda.synchronize()
    steps0, ticks0 = eng.steps, eng.ticks
    with program_spans() as events, profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for name in spans:
        delattr(eng, name)
    run_ms = sum(a.elapsed_time(b) for a, b in events)
    nodes = {}
    counts = read_launches()
    for key, p in sorted(eng.programs.items()):
        if p.graph is not None:
            nodes[key] = device_kernels(
                lambda: p._forward(eng._bucket_states(p.nb)))
    for kern, n in zip(KERNELS, counts.values()):
        kern.launches = n       # the re-captures launched nothing
    log(f'[profile] step programs: device span of the runs '
        f'{run_ms:.1f} ms over {len(events)} runs ({run_ms / len(events):.3f}'
        f' ms a step) in {wall_ms:.1f} ms wall (idle share outside them '
        f'{1 - run_ms / wall_ms:.3f}); device kernels a step by captured '
        f'step shape {json.dumps({str(k): n for k, n in nodes.items()})}')
    steps, ticks = eng.steps - steps0, eng.ticks - ticks0
    avg = prof.key_averages()
    labels = {'engine.' + name for name in spans}
    for name in spans:
        # the host-side range: device time of the kernels launched inside
        # it; the device-side range: first kernel's start to last's end
        ev = {e.device_type == DeviceType.CPU: e for e in avg
              if e.key == 'engine.' + name}
        if True not in ev:
            log(f'[profile] {name}: no host range recorded')
            continue
        busy = ev[True].device_time_total / 1e3
        span = ev[False].self_device_time_total / 1e3 if False in ev \
            else float('nan')
        calls = ev[True].count
        log(f'[profile] {name}: {calls} calls over {ticks} ticks; device '
            f'time of the copies it launched {busy:.3f} ms '
            f'({busy / calls:.3f} ms a call, {busy / steps:.3f} ms per engine '
            f'step); its span on the device, gaps included, {span:.3f} ms '
            f'({span / calls:.3f} ms a call)')
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in avg
            if e.device_type != DeviceType.CPU and e.self_device_time_total
            and e.key not in labels]
    busy = sum(ms for _, ms, _ in kern)
    if not busy:
        log('[profile] torch.profiler recorded no device time')
        return {}
    groups = {'paged_attention': 0.0, 'gather_rope': 0.0,
              'embed_gather': 0.0, 'fused_page_write': 0.0,
              'cow_page_copy': 0.0, 'matmul': 0.0, 'other': 0.0}
    for key, ms, _ in kern:
        name = ('paged_attention' if 'paged_attention' in key else
                'gather_rope' if 'gather_rope' in key else
                'embed_gather' if 'gather_rows' in key else
                'fused_page_write' if 'fused_page_write' in key else
                'cow_page_copy' if 'cow_page_copy' in key else
                'matmul' if ('gemm' in key.lower() or 'cutlass' in key
                             or 'nvjet' in key) else 'other')
        groups[name] += ms
    log(f'[profile] window {wall_ms:.1f} ms wall over {steps} engine steps'
        + (' (host traced too)' if spans else '') + ', '
        f'device busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}); '
        f'device ms by group '
        f'{json.dumps({k: round(v, 2) for k, v in groups.items()})}; per '
        f'step {json.dumps({k: round(v / steps, 3) for k, v in groups.items()})}'
        f'; device kernels a step {sum(n for _, _, n in kern) / steps:.1f}')
    for key, ms, n in sorted(kern, key=lambda x: -x[1])[:8]:
        log(f'[profile]   {ms:8.2f} ms  x{n:<5d} {key[:90]}')
    return dict({k: v / steps for k, v in groups.items()},
                kernels=sum(n for _, _, n in kern) / steps)


class count_calls:
    """Counts the calls of ``module.name`` until :meth:`undo`."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.fn = getattr(module, name)

        def counted(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)
        setattr(module, name, counted)

    def undo(self):
        setattr(self.module, self.name, self.fn)


# ----------------------------------------------------------------- phase 5
GLM_TAILS = (40, 120, 77, 23, 9, 64, 100, 31)


def glm_requests(cfg, rng, system, uid0, tails=GLM_TAILS, new_tokens=16):
    """Requests of ``system`` + a distinct tail each. The fifth tail is the
    head of the first one's: that prompt stops inside a page the first
    request published, so its admission copies on write."""
    made = []
    for i, n in enumerate(tails):
        tail = rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
        if i == 4:
            tail = made[0][:n].copy()
        made.append(tail)
    return [Request(uid=uid0 + i, prompt=np.concatenate([system, t]),
                    max_new_tokens=new_tokens) for i, t in enumerate(made)]


def phase_paged(cfg, tag: str, attn_kernel: str, int8: bool = False,
                device='cuda', dtype=torch.bfloat16, rows=None,
                apply_seq: int = 0, mesh_spec: str = '',
                observe: bool = False, wide: bool = False,
                modes=()) -> dict:
    """Serve ``cfg`` through the paged pool and the prefix cache: two waves
    of 4 requests sharing a 256-token system prompt (one copies on write),
    16 new tokens each; every attend goes through ``attn_kernel``. With
    ``int8``, the same waves again on the same weights through an int8
    pool, every attend through ``paged_attention_quant``. With
    ``mesh_spec``, the same runs again on the same weights under that
    serving mesh: greedy tokens bitwise the unsharded runs', the attention
    kernel launched once per kv-head shard, the maintenance kernels as
    often as unsharded. With ``observe``, after the first run the same
    waves in turns without and with telemetry and then under a fault script
    (``observe_waves``), and with ``wide`` the waves on a 64-slot engine
    (``check_wide_engine``). With ``modes``, the waves again on fresh
    engines with segment-packed prefill and the async loop
    (:func:`serve_modes`). On the card each run without a mesh is held
    against its eager twin (``serve_waves(eager=True)``, bitwise). With
    ``apply_seq``, then the layer-0 comparison
    and Model.apply at that S on the same weights. -> launches by run
    (``tag``, ``tag + '_off'``, ``tag + '_telemetry'``, ``tag +
    '_chaos'``, ``tag + '_int8'``, ``tag + '_mesh'``, ``tag +
    '_mesh_int8'``, the apply runs)."""
    on_card = torch.device(device).type == 'cuda'
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device=device, dtype=dtype)
    table = model.build_table(params)
    if on_card:
        torch.cuda.synchronize()
    log(f'[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, '
        f'{cfg.num_heads}H/{cfg.num_kv_heads}KV'
        + (f' MLA r {cfg.mla.kv_lora_rank} + {cfg.mla.qk_rope_dim}'
           if cfg.mla else '')
        + (f', MoE {cfg.moe.num_experts} experts top-{cfg.moe.top_k} + '
           f'{cfg.moe.num_shared} shared' if cfg.moe else '')
        + f', vocab {cfg.vocab_size}; weights + table made in '
        f'{time.perf_counter() - t0:.1f}s; table '
        f'{tuple(table.table.shape)} {str(table.table.dtype)[6:]}')
    rng = np.random.default_rng(SEED)
    system = rng.integers(3, cfg.vocab_size, size=256).astype(np.int32)
    reqs = glm_requests(cfg, rng, system, 0)
    warm = rng.integers(3, cfg.vocab_size, size=40).astype(np.int32)
    runs = [(tag, attn_kernel, False, None)]
    if int8:
        runs.append((tag + '_int8', 'paged_attention_quant', True, None))
    mesh = card_mesh(mesh_spec) if mesh_spec else None
    if mesh is not None:
        runs += [(t.replace(tag, tag + '_mesh', 1), k, q, mesh)
                 for t, k, q, _ in runs]
    out = {}
    for run_tag, kernel, kv_quant, run_mesh in runs:
        # one device on the card: an eager twin first, the replays held
        # against it
        want = serve_waves(model, params, table, run_tag, kernel, kv_quant,
                           system, warm, reqs, rng, device, dtype,
                           eager=True)[4] \
            if on_card and run_mesh is None else None
        out[run_tag] = serve_waves(model, params, table, run_tag, kernel,
                                   kv_quant, system, warm, reqs, rng, device,
                                   dtype, mesh=run_mesh, expect=want)
        del want
        if on_card:
            free()
        if run_tag == tag and wide:
            check_wide_engine(model, params, table, tag, warm, reqs, dtype)
            free()
        if run_tag == tag and modes:
            out.update(serve_modes(model, params, table, tag, warm, reqs,
                                   dtype, modes, device))
        if run_tag == tag and observe:
            out.update(observe_waves(model, params, table, tag, attn_kernel,
                                     system, warm, reqs, rng, device, dtype,
                                     out[tag]))
    for run_tag, kernel, _, run_mesh in runs:
        if run_mesh is None:
            continue
        base_tag = run_tag.replace(tag + '_mesh', tag, 1)
        (lb, tb, *_), (lm, tm, *_) = out[base_tag], out[run_tag]
        assert tm == tb, f'{run_tag}: greedy tokens differ from {base_tag}'
        H = run_mesh.shape[1]
        assert lm[kernel] == lm['sharded_paged_attention'] \
            == H * lb[kernel], (run_tag, lm, lb)
        for name in ('fused_page_write', 'cow_page_copy', 'gather_rope'):
            assert lm[name] == lb[name], (run_tag, name, lm, lb)
        log(f'[{run_tag}] greedy tokens bitwise those of [{base_tag}] '
            f'({sum(map(len, tm))} tokens); {kernel} {lm[kernel]} launches '
            f'= {H} x {lb[kernel]} (one per kv-head shard); fused_page_write '
            f'{lm["fused_page_write"]}, cow_page_copy {lm["cow_page_copy"]} '
            'as unsharded')
    if int8:
        (l16, tok16, b16, *_), (l8, tok8, b8, *_) = out[tag], \
            out[tag + '_int8']
        log(f'[{tag}_int8] KV pool bytes {b8} int8 against {b16} bf16 '
            f'({b8 / b16:.3f}); greedy tokens equal to the bf16 run\'s: '
            f'{token_share(tok8, tok16)} (reported, not checked)')
        for t16 in [t for t in out if t + '_int8' in out]:
            p16, p8 = out[t16][3], out[t16 + '_int8'][3]
            if p16 and p8:
                log(f'[{t16}_int8] device ms a step, "other" {p8["other"]:.3f}'
                    f' against bf16\'s {p16["other"]:.3f}; device kernels a '
                    f'step {p8["kernels"]:.1f} against {p16["kernels"]:.1f}')
    phases = {k: v[0] for k, v in out.items()}
    if apply_seq:
        if not cfg.mla:       # MLA's layer 0 has no LN1 + [Wq|Wk|Wv]
            check_layer0(model, params, table, LAYER0_COUNTS, rows)
        phases.update(phase_apply(model, params, table, apply_seq, tag))
    return phases


def serve_waves(model, params, table, tag, attn_kernel, kv_quant, system,
                warm, reqs, rng, device, dtype, mesh=None, telemetry=False,
                chaos=None, profile=True, inspect=None, eager=False,
                expect=None):
    """One paged engine over the two waves of ``reqs`` (fresh Request
    objects with their prompts); under ``mesh``, with a pool the mesh's
    pool axis divides, the state at rest checked and the device time of
    ``_rep_in`` / ``_shard_out`` read from the profiler's trace. With
    ``telemetry``, the engine records; with ``chaos`` (a ``ChaosScript``,
    armed after the warm-up) it injects faults, and the waves' outcomes are
    left to the caller; ``inspect(eng, reqs, steps, seconds)`` sees the
    engine after the waves (then, with ``profile``, a profiled third
    batch). With ``eager`` (every step inside ``_eager_steps()``, no
    profile) or ``expect``, the waves are followed by ``score()`` of the
    first request's first 100 tokens, and with ``expect`` (an eager run's
    digest) tokens, score logits and pool are held bitwise against it
    (:func:`check_replay`). -> (launches, greedy tokens, pool bytes at
    rest, the profile, the digest or None)."""
    cfg = model.cfg
    on_card = torch.device(device).type == 'cuda'
    num_pages = None
    if mesh is not None:        # the engine's default pool, cut to divide
        num_pages = glm_pool_pages() - glm_pool_pages() % mesh.shape[0]
    eng = ServingEngine(model, params, max_slots=GLM_SLOTS, max_seq=GLM_SEQ,
                        precomputed=table, seed=SEED, dtype=dtype,
                        chunk_size=16, fused_gather_rope=True,
                        prefix_cache=True, page_size=GLM_PS,
                        num_pages=num_pages, kv_quant=kv_quant,
                        attn_backend='cuda', mesh=mesh, telemetry=telemetry,
                        fault_injector=chaos, device=device)
    assert eng.paged and eng._fused_maint \
        and eng.fused_gather_rope == (table is not None)
    log(f'[{tag}] paged pool: {eng.num_pages} pages x {eng.page_size} tokens '
        f'x {cfg.num_layers} layers, leaves {sorted(eng.states["layer0"])}'
        + ('' if mesh is None else f'; {mesh_text(mesh)}, backend '
           f'{type(eng.attn_backend).__name__}'))
    reqs = [Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in reqs]
    if eager:
        tag += ' eager'
    with steps_mode(eager):
        # warm-up (cuBLAS handles, allocator, graphs) with tokens no
        # request shares
        eng.submit(Request(uid=100, prompt=warm, max_new_tokens=2))
        eng.run()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if chaos is not None:
            chaos.arm(eng)
        steps0, drops0, cow0 = eng.steps, eng.moe_token_drops, eng.cow_copies
        quantizer = count_calls(A, 'kv_values')
        zero_launches()
        spans = program_spans() if on_card else contextlib.nullcontext([])
        with spans as events:
            waves = []
            t_all = time.perf_counter()
            for wave in (reqs[:4], reqs[4:]):
                t0 = time.perf_counter()
                for r in wave:
                    eng.submit(r)
                eng.run()
                if on_card:
                    torch.cuda.synchronize()
                waves.append(time.perf_counter() - t0)
            dt = time.perf_counter() - t_all
    launches = read_launches()
    quantizer.undo()
    # the paged write quantizes inside fused_page_write: no eager
    # quantizer, one write launch a layer and a step
    assert quantizer.calls == 0, \
        f'{tag}: the eager quantizer ran {quantizer.calls}x'
    assert not on_card or launches['fused_page_write'] == \
        (eng.steps - steps0) * cfg.num_layers, launches
    for r in reqs:
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
        if chaos is None:
            assert r.status is RequestStatus.FINISHED, \
                (r.uid, r.status, r.error)
            assert len(r.generated) == 16, (r.uid, len(r.generated))
    for r in reqs[4:]:
        assert r.prefix_hit_tokens > 0, (r.uid, r.prefix_hit_tokens)
    cow_req = reqs[4]
    assert cow_req.prefix_hit_tokens == len(cow_req.prompt) - 1, \
        cow_req.prefix_hit_tokens
    assert eng.cow_copies > 0, 'no copy-on-write ran'
    for name in ('fused_page_write', 'cow_page_copy', attn_kernel) \
            + (('gather_rope',) if table is not None else ()):
        assert launches[name] > 0, f'{name} never launched on the paged path'
    stats = eng.stats(reqs)
    steps = eng.steps - steps0
    shards = 1 if mesh is None else mesh.shape[1]
    assert launches[attn_kernel] == shards * cfg.num_layers * steps, \
        (attn_kernel, launches[attn_kernel], steps)
    # one gather a step (none without the table); one copy-on-write launch
    # per cache (layer 0, each stacked body slot) and copy
    assert not on_card or launches['gather_rope'] + launches[
        'embed_gather'] == (steps if table is not None else 0), \
        (launches, steps)
    if on_card and mesh is None:
        assert launches['cow_page_copy'] == \
            len(eng._pools) * (eng.cow_copies - cow0), \
            (launches, len(eng._pools), eng.cow_copies - cow0)
    if kv_quant:
        assert launches['paged_attention'] == 0, launches
    ttft = [[r.first_token_t - r.submit_t for r in w if r.first_token_t]
            for w in (reqs[:4], reqs[4:])]
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    log(f'[{tag}] 8 requests (system prompt 256 + tails {list(GLM_TAILS)}), '
        f'{stats["tokens"]} new tokens in {dt:.3f}s -> '
        f'{stats["tokens"] / dt:.1f} tok/s; {steps} steps '
        f'({dt / steps * 1e3:.2f} ms/step); wave seconds '
        f'{[round(w, 3) for w in waves]}; mean TTFT without a hit (wave 1) '
        f'{np.mean(ttft[0]):.3f}s, with a hit (wave 2) {np.mean(ttft[1]):.3f}s'
        f'; peak memory {peak:.2f} GiB'
        + ('; ' + span_text(events, dt, steps) if on_card else ''))
    log(f'[{tag}] prefix hits {stats["prefix_hits"]}, misses '
        f'{stats["prefix_misses"]}, hit tokens {stats["prefix_hit_tokens"]} '
        f'(per request {[r.prefix_hit_tokens for r in reqs]}), copy-on-write '
        f'{stats["cow_copies"]}, pages in use {stats["pages_in_use"]}, '
        f'preemptions {stats["preemptions"]}, MoE token drops '
        f'{eng.moe_token_drops - drops0}')
    if inspect is not None:
        inspect(eng, reqs, steps, dt)
    digest = None
    if eager or expect is not None:
        with steps_mode(eager):
            scores = eng.score([reqs[0].prompt[:100]])
        digest = replay_digest(eng, [r.generated for r in reqs], scores)
        if expect is not None:
            check_replay(f'[{tag}]', eng, digest, expect)
    if on_card:
        log_programs(f'[{tag}]', eng)
    log(f'[{tag}] launches {json.dumps(launches)} over {steps} steps '
        f'({attn_kernel}: {shards * cfg.num_layers} a step, '
        f'{"one gather" if table is not None else "no gather (no table)"} a '
        f'step, cow_page_copy {launches["cow_page_copy"]} for '
        f'{eng.cow_copies - cow0} copies)'
        + ('' if chaos else '; all requests FINISHED with 16 tokens (finite '
           'logits)'))
    if mesh is not None:
        check_at_rest(eng, mesh, tag)
        leaves = [b for leaf in state_leaves(eng.states)
                  for row in leaf.blocks for b in row]
    else:
        leaves = [x for pool, _ in eng._pools for x in pool.values()]
    prof = profile_engine(eng, glm_requests(cfg, rng, system, 200,
                                            tails=(50, 17, 90, 33)),
                          spans=() if mesh is None else ('_rep_in',
                                                         '_shard_out')) \
        if on_card and profile and not eager else {}
    return launches, [r.generated for r in reqs], nbytes(*leaves), prof, \
        digest


# Phase 5's fault script, in ticks and steps after the warm-up: a steal at
# tick 3 that leaves CHAOS_LEFT pages (the waves then hold 8 pages and need
# 4 more a tick while 4 prompts prefill, and about 86 at their longest),
# given back at tick CHAOS_RESTORE; uid 2 cancelled mid-prefill at tick 4;
# slot 1's lane (uid 1, prefilling) poisoned at the waves' fifth dispatch
CHAOS_LEFT, CHAOS_RESTORE = 16, 20


class ChaosScript(ScriptedFaults):
    """``ScriptedFaults`` whose ticks and steps count from where ``arm``
    is called (after the warm-up), whose steal leaves ``CHAOS_LEFT`` pages
    of what the pool could give at that tick, and which records the uid of
    each lane it poisons."""

    def __init__(self):
        super().__init__()
        self.steal_at = None
        self.taken = 0
        self.poisoned = []

    def arm(self, eng) -> None:
        t, s = eng.ticks, eng.steps
        self.steal_at = t + 3
        self.restore_pages_at.add(t + CHAOS_RESTORE)
        self.cancel_uids[t + 4] = [2]
        self.nan_lanes[s + 4] = [1]

    def before_step(self, eng) -> None:
        steal = eng.ticks == self.steal_at
        if steal:
            self.steal_pages[eng.ticks] = eng.kv.reclaimable() - CHAOS_LEFT
        super().before_step(eng)
        if steal:
            self.taken = len(self.stolen)

    def poison_lanes(self, eng, step_idx):
        lanes = super().poison_lanes(eng, step_idx)
        self.poisoned += [eng.slot_req[s].uid for s in lanes
                          if eng.slot_req[s] is not None]
        return lanes


def phase_table(tel) -> dict:
    """{kind: {phase: (observations, mean ms, p50 ms, p99 ms)}} of the
    engine's step phases, kinds that ran only."""
    out = {}
    for labels, h in tel.registry.find(TM.STEP_PHASE).items():
        lb = dict(labels)
        if h.count:
            out.setdefault(lb['kind'], {})[lb['phase']] = (
                h.count, h.mean * 1e3, h.percentile(50) * 1e3,
                h.percentile(99) * 1e3)
    return out


def check_pool_whole(eng, tag) -> None:
    """Every usable page is free or held by the radix index, once."""
    kv = eng.kv
    radix, stack = [], list(kv.root.children.values())
    while stack:
        node = stack.pop()
        radix.append(node.page)
        stack.extend(node.children.values())
    free = list(kv._free)
    assert kv.pages_free() + kv.pages_in_use() == kv.num_pages - 1
    assert kv.pages_in_use() == len(radix), (kv.pages_in_use(), len(radix))
    assert sorted(free + radix) == list(range(1, kv.num_pages)), \
        f'{tag}: pages leaked or listed twice'
    log(f'[{tag}] pool whole: {kv.pages_free()} free + {kv.pages_in_use()} '
        f'in use (all {len(radix)} held by the radix index) = '
        f'{kv.num_pages - 1} usable pages of {kv.num_pages}')


# the wide engine's pool: phase 5's default for 4 slots, held by the 8-slot
# engine it is compared with too
WIDE_SLOTS, WIDE_PAGES = 64, 1537


def check_wide_engine(model, params, table, tag, warm, reqs, dtype) -> None:
    """The 8 requests of the waves submitted at once to an 8-slot engine
    and to a ``WIDE_SLOTS``-slot one, both on a pool of ``WIDE_PAGES``
    pages: no slot above 7 is ever active, so every dispatch of the wide
    engine runs at bucket 8 (its programs' keys), and its greedy tokens
    and lane counts equal the 8-slot engine's, bitwise."""
    cfg = model.cfg
    out = {}
    for slots in (8, WIDE_SLOTS):
        eng = ServingEngine(model, params, max_slots=slots, max_seq=GLM_SEQ,
                            precomputed=table, seed=SEED, dtype=dtype,
                            chunk_size=16, fused_gather_rope=True,
                            prefix_cache=True, page_size=GLM_PS,
                            num_pages=WIDE_PAGES, attn_backend='cuda',
                            device='cuda')
        eng.submit(Request(uid=100, prompt=warm, max_new_tokens=2))
        eng.run()
        run = [Request(uid=r.uid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens) for r in reqs]
        torch.cuda.synchronize()
        steps0 = eng.steps
        zero_launches()
        t0 = time.perf_counter()
        for r in run:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        steps = eng.steps - steps0
        assert all(r.status is RequestStatus.FINISHED for r in run), \
            [(r.uid, r.status, r.error) for r in run]
        assert {k[1] for k in eng.programs} == {8}, sorted(eng.programs)
        assert launches['paged_attention'] == cfg.num_layers * steps \
            == launches['fused_page_write'], (launches, steps)
        stats = eng.stats(run)
        out[slots] = ([r.generated for r in run], stats['lanes_dispatched'],
                      stats['lane_tokens'])
        log(f'[{tag}_wide] {slots} slots, {WIDE_PAGES} pages, the 8 requests '
            f'at once: {stats["tokens"]} new tokens in {dt:.3f}s -> '
            f'{stats["tokens"] / dt:.1f} tok/s; {steps} steps '
            f'({dt / steps * 1e3:.2f} ms/step); programs '
            f'{sorted(eng.programs)}; lanes dispatched '
            f'{stats["lanes_dispatched"]} for {stats["lane_tokens"]} tokens')
        del eng
        free()
    assert out[WIDE_SLOTS] == out[8], \
        f'{tag}_wide: the {WIDE_SLOTS}-slot engine differs from the 8-slot one'
    log(f'[{tag}_wide] {WIDE_SLOTS} slots: every dispatch at bucket 8; '
        f'greedy tokens ({sum(map(len, out[8][0]))}) and lane counts bitwise '
        'the 8-slot engine\'s')


def observe_waves(model, params, table, tag, attn_kernel, system, warm,
                  reqs, rng, device, dtype, base) -> dict:
    """The waves of ``tag``'s run again on the same weights, five times.
    Four in turns without and with telemetry (off, on, on, off; the two
    recording runs share one ``Telemetry``): greedy tokens bitwise
    ``base``'s, the same launches, every phase observed once a step; the
    phases' host ms by step kind, and ms/step of each turn. Then under
    ``ChaosScript`` (telemetry on): preemptions happen, the cancelled
    request ends CANCELLED, the poisoned one FAILED('nonfinite_logits'),
    every other FINISHED with ``base``'s tokens; after the stolen pages
    return no page leaks; the Chrome trace parses from a file with one
    track per request. -> launches by run."""
    on_card = torch.device(device).type == 'cuda'
    launches0, tokens0 = base[0], base[1]
    out = {}
    t_tag = tag + '_telemetry'
    shared = TM.Telemetry()
    ms = {False: [], True: []}
    steps = []

    def timed(on):
        def inspect(eng, _reqs, n, seconds):
            ms[on].append(seconds / n * 1e3)
            if on:
                steps.append(eng.steps)
        return inspect
    for on in (False, True, True, False):
        run_tag = t_tag if on else tag + '_off'
        out[run_tag] = serve_waves(
            model, params, table, run_tag, attn_kernel, False, system, warm,
            reqs, rng, device, dtype, telemetry=shared if on else False,
            profile=False, inspect=timed(on))
        launches, tokens = out[run_tag][:2]
        assert tokens == tokens0, f'{run_tag}: greedy tokens differ'
        assert launches == launches0, (launches, launches0)
        if on_card:
            free()
    phases = phase_table(shared)
    for ph in TM.PHASES:
        n = sum(k[ph][0] for k in phases.values())
        assert n == sum(steps), (ph, n, steps)
    log(f'[{t_tag}] greedy tokens bitwise those of [{tag}] '
        f'({sum(map(len, tokens0))} tokens) and launches equal in every '
        f'turn; each of the {len(TM.PHASES)} phases observed {sum(steps)} '
        'times over the two recording engines = their steps (warm-ups '
        f'included); ms/step in turns off / on / on / off {ms[False][0]:.2f}'
        f' / {ms[True][0]:.2f} / {ms[True][1]:.2f} / {ms[False][1]:.2f}: '
        f'with telemetry {np.mean(ms[True]):.2f}, without '
        f'{np.mean(ms[False]):.2f}')
    for kind, row in sorted(phases.items()):
        share = row['dispatch'][1] / sum(v[1] for v in row.values())
        log(f'[{t_tag}] {kind:7s} host ms mean / p50 / p99 (steps): '
            + '; '.join(f'{ph} {m:.3f} / {p50:.3f} / {p99:.3f}'
                        for ph, (_, m, p50, p99) in row.items())
            + f' ({next(iter(row.values()))[0]}); dispatch {share:.3f} of '
            'the mean step')
    log(f'[{t_tag}] phases json {json.dumps(phases)}')

    c_tag = tag + '_chaos'
    chaos = ChaosScript()

    def check_chaos(eng, creqs, n, seconds):
        stats = eng.stats(creqs)
        assert stats['preemptions'] > 0, 'the steal forced no preemption'
        assert chaos.poisoned == [1], chaos.poisoned
        want = {1: ('FAILED', 'nonfinite_logits'), 2: ('CANCELLED', None)}
        names = eng.telemetry.tracer.names
        for r, base_tok in zip(creqs, tokens0):
            status = (r.status.name, r.error)
            assert status == want.get(r.uid, ('FINISHED', None)), \
                (r.uid, status)
            if r.uid not in want:
                assert r.generated == base_tok, \
                    f'{c_tag}: uid {r.uid} greedy tokens differ from [{tag}]'
        assert TM.EV_FIRST_TOKEN not in names(2), names(2)   # mid-prefill
        assert stats['cancelled'] == 1 and stats['failed'] == 1, stats
        chaos.release_stolen(eng)
        check_pool_whole(eng, c_tag)
        tmp = tempfile.mkdtemp()
        try:
            path = os.path.join(tmp, 'trace.json')
            eng.telemetry.write_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            shutil.rmtree(tmp)
        tracks = sorted(e['args']['name'] for e in trace['traceEvents']
                        if e['ph'] == 'M' and e['name'] == 'thread_name')
        assert tracks == sorted(['engine', 'request 100']
                                + [f'request {r.uid}' for r in creqs]), \
            tracks
        log(f'[{c_tag}] steal of {chaos.taken} pages at the waves\' tick 3 '
            f'(leaving {CHAOS_LEFT}), given back at tick {CHAOS_RESTORE}: '
            f'{stats["preemptions"]} preemptions (per request '
            f'{[r.preemptions for r in creqs]}); uid 2 CANCELLED '
            'mid-prefill, uid 1 FAILED(nonfinite_logits) (its lane '
            f'poisoned), the other {len(creqs) - 2} FINISHED with greedy '
            f'tokens bitwise those of [{tag}]; fault events '
            f'{[x for x in names(None) if x.startswith("FAULT")]}; Chrome '
            f'trace {len(trace["traceEvents"])} events, {len(tracks)} '
            'tracks (one a request + the engine), parsed from a file; '
            f'ms/step {seconds / n * 1e3:.2f} over {n} steps')
    out[c_tag] = serve_waves(
        model, params, table, c_tag, attn_kernel, False, system, warm, reqs,
        rng, device, dtype, telemetry=True, chaos=chaos, profile=False,
        inspect=check_chaos)
    return out


# the engine options of each mode of serve_modes
MODES = {'sync': {}, 'packed': dict(pack_prefill=True),
         'async': dict(async_loop=True),
         'both': dict(pack_prefill=True, async_loop=True)}
# phase 5's modes (the synchronous unpacked run first), then the async
# loop once more with telemetry (the overlap fraction)
GLM_MODES = (('sync', False), ('packed', False), ('async', False),
             ('both', False), ('async', True))


@contextlib.contextmanager
def program_runs(known):
    """Like :func:`program_spans`, and each run also says whether it was
    the first of its program (not in ``known``, the programs that ran
    before: an eager forward and, on the card, the capture) and how many
    host seconds it took. Yields the list of (start, end, first, host
    seconds)."""
    runs, seen = [], set(known)
    run = StepProgram.run

    def timed(prog, graphs):
        first = prog not in seen
        seen.add(prog)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run(prog, graphs)
        end.record()
        runs.append((start, end, first, time.perf_counter() - t0))
        return out
    StepProgram.run = timed
    try:
        yield runs
    finally:
        StepProgram.run = run


def phase_sums(eng) -> dict:
    """(observations, seconds) of each step phase and of the async loop's
    overlap, summed over step kinds."""
    reg = eng.telemetry.registry
    out = {}
    for name, key in ((TM.STEP_PHASE, 'phase'), (TM.STEP_OVERLAP, None)):
        for labels, h in reg.find(name).items():
            ph = dict(labels)[key] if key else 'overlap'
            n, t = out.get(ph, (0, 0.0))
            out[ph] = (n + h.count, t + h.total)
    return out


def serve_modes(model, params, table, tag, warm, reqs, dtype, modes,
                device='cuda') -> dict:
    """The waves of ``tag``'s run on a fresh engine for each ``(mode,
    telemetry)`` of ``modes`` (a key of :data:`MODES`): segment-packed
    prefill, the async double-buffered loop, or both. The first is the
    synchronous unpacked run the others are held against: greedy tokens
    equal, MoE drops equal, and ``score()`` of the first request's first
    100 tokens bitwise or its largest difference printed (a packed grid's
    matmuls have other row counts, so cuBLAS may take other algorithms).
    Each prints ms/step, the device span of the step programs a step and
    the idle share outside them; ms/step and the span without the steps
    that ran a program for the first time (its eager forward and capture:
    their host seconds taken out of the wall time; in the async loop that
    also takes out some of the previous step's device time, which a
    capture waits for), ``prefill_lane_utilization`` and
    ``lanes_dispatched`` over the waves, its programs' captures and
    replays, launches per layer and step, and with telemetry the async
    loop's overlap fraction: ``overlap_s`` over the host_schedule,
    radix_lookup and pack_layout seconds of the waves. -> (launches,
    greedy tokens) by run."""
    cfg = model.cfg
    attn = 'paged_attention_mla' if cfg.mla else 'paged_attention'
    out, base, seen = {}, None, {}
    for mode, telemetry in modes:
        seen[mode] = seen.get(mode, 0) + 1
        run_tag = f'{tag}_{mode}' + ('_telemetry' if telemetry else
                                     f'_{seen[mode]}' if seen[mode] > 1
                                     else '')
        eng = ServingEngine(model, params, max_slots=GLM_SLOTS,
                            max_seq=GLM_SEQ, precomputed=table, seed=SEED,
                            dtype=dtype, chunk_size=16,
                            fused_gather_rope=True, prefix_cache=True,
                            page_size=GLM_PS, attn_backend='cuda',
                            telemetry=telemetry, device=device,
                            **MODES[mode])
        assert eng._graphs == (device == 'cuda')
        assert eng.pack_prefill == ('pack_prefill' in MODES[mode])
        eng.submit(Request(uid=100, prompt=warm, max_new_tokens=2))
        eng.run()
        run = [Request(uid=r.uid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens) for r in reqs]
        torch.cuda.synchronize()
        steps0, drops0 = eng.steps, eng.moe_token_drops
        lanes0, tokens0 = eng.lanes_dispatched, eng.lane_tokens
        sums0 = phase_sums(eng) if telemetry else {}
        zero_launches()
        with program_runs(eng.programs.values()) as runs:
            t0 = time.perf_counter()
            for wave in (run[:4], run[4:]):
                for r in wave:
                    eng.submit(r)
                eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = read_launches()
        events = [(a, b) for a, b, _, _ in runs]
        later = [(a, b) for a, b, first, _ in runs if not first]
        first_s = sum(h for _, _, first, h in runs if first)
        later_ms = sum(a.elapsed_time(b) for a, b in later)
        steady = (f'; without the {len(runs) - len(later)} first runs '
                  f'({first_s * 1e3:.1f} host ms): '
                  f'{(dt - first_s) / len(later) * 1e3:.2f} ms/step, device '
                  f'span {later_ms / len(later):.3f} ms a step')
        steps = eng.steps - steps0
        assert eng._pending is None
        for r in run:
            assert r.status is RequestStatus.FINISHED, \
                (run_tag, r.uid, r.status, r.error)
            assert len(r.generated) == 16, (r.uid, len(r.generated))
        lanes = eng.lanes_dispatched - lanes0
        util = (eng.lane_tokens - tokens0) / lanes
        drops = eng.moe_token_drops - drops0
        overlap = ''
        if telemetry:
            sums = phase_sums(eng)
            d = {k: (sums[k][0] - sums0.get(k, (0, 0.0))[0],
                     sums[k][1] - sums0.get(k, (0, 0.0))[1]) for k in sums}
            host = sum(d[ph][1] for ph in ('host_schedule', 'radix_lookup',
                                           'pack_layout'))
            if 'overlap' in d:
                overlap = (f'; overlap fraction {d["overlap"][1] / host:.3f}'
                           f' ({d["overlap"][0]} observations, '
                           f'{d["overlap"][1] * 1e3:.1f} of '
                           f'{host * 1e3:.1f} host ms of schedule, radix '
                           f'and staging); host ms a step by phase '
                           + json.dumps({ph: round(d[ph][1] / d[ph][0] * 1e3,
                                                   3) for ph in TM.PHASES}))
        scores = eng.score([run[0].prompt[:100]])[0]
        tokens = [r.generated for r in run]
        progs = list(eng.programs.values())
        per_step = {name: round(launches[name] / steps, 3)
                    for name in (attn, 'fused_page_write', 'gather_rope',
                                 'embed_gather', 'cow_page_copy')}
        assert device != 'cuda' or launches[attn] \
            == launches['fused_page_write'] == cfg.num_layers * steps \
            and launches['gather_rope'] + launches['embed_gather'] == steps, \
            (launches, steps)
        if base is None:
            base = (tokens, scores, drops)
            same = 'the reference run'
        else:
            assert tokens == base[0], \
                f'{run_tag}: greedy tokens differ from [{tag}_sync]'
            assert drops == base[2], (run_tag, drops, base[2])
            bitwise = np.array_equal(scores.view(np.uint32),
                                     base[1].view(np.uint32))
            diff = float(np.abs(scores - base[1]).max())
            same = (f'greedy tokens ({sum(map(len, tokens))}) equal to '
                    f'[{tag}_sync]\'s, MoE drops equal ({drops}); score '
                    f'logits {scores.shape} '
                    + ('bitwise' if bitwise else
                       f'not bitwise, largest difference {diff:.3e}'))
        captures = [p.capture_ms for p in progs if p.graph is not None]
        log(f'[{run_tag}] {mode}: {sum(map(len, tokens)) / dt:.1f} tok/s; '
            f'{steps} steps ({dt / steps * 1e3:.2f} ms/step); '
            + span_text(events, dt, steps) + steady
            + f'; prefill_lane_utilization {util:.3f} ({lanes} lanes '
            f'dispatched); {len(progs)} programs, {len(captures)} captures '
            f'({sum(captures):.1f} ms), {sum(p.replays for p in progs)} '
            f'replays; launches a step {json.dumps(per_step)}, a layer and '
            f'a step {attn} {launches[attn] / steps / cfg.num_layers:.3f}, '
            f'fused_page_write '
            f'{launches["fused_page_write"] / steps / cfg.num_layers:.3f}'
            + overlap + f'; {same}')
        log_programs(f'[{run_tag}]', eng)
        out[run_tag] = (launches, tokens)
        del eng
        free()
    return out


def state_leaves(states) -> list:
    return [leaf for st in states.values()
            for layer in (st if isinstance(st, list) else [st])
            for leaf in layer.values()]


def check_at_rest(eng, mesh, tag) -> None:
    """Between steps every pool leaf is a grid of blocks on the mesh's
    devices: pages ``partition_pages(NP, P)[i]`` and kv-head block ``h`` of
    the gathered leaf, bit for bit."""
    P, H = mesh.shape
    parts = partition_pages(eng.num_pages, P)
    n = 0
    for leaf in state_leaves(eng.states):
        assert isinstance(leaf, ShardedLeaf), type(leaf)
        full = gather_leaf(leaf, eng.device)
        lead = leaf.spec.index('pool')
        for i in range(P):
            for h in range(H):
                b = leaf.blocks[i][h]
                assert b.device == mesh.devices[i][h] and b.is_contiguous()
                want = full.narrow(lead, parts[i].start, len(parts[i]))
                if 'heads' in leaf.spec:
                    dim = leaf.spec.index('heads')
                    per = full.shape[dim] // H
                    want = want.narrow(dim, h * per, per)
                assert torch.equal(b, want), (tag, i, h)
                n += 1
    log(f'[{tag}] at rest: {n} blocks of {len(state_leaves(eng.states))} '
        f'leaves on their mesh devices, pages {[str(r) for r in parts]} '
        'and kv-head blocks of the gathered leaves')


# ----------------------------------------------------------------- phase 7
PYTHIA = 'pythia_6_9b'
PYTHIA_LAYER0_COUNTS = (1, 4, 64, 2048)
PYTHIA_APPLY_SEQ = 2048                  # the config's max_seq_len


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return nbytes(tree)


def phase_pythia(rows) -> dict:
    """pythia-6.9b, the paper's parallel block (LayerNorm, MHA: G 1), at full
    width and its DEPTHS depth on seeded random bf16 weights: dense caches with
    the table (whose rows also carry layer 0's FFN and skip) and the fused
    gather-RoPE, then the same requests without the table; the paged pool with
    the radix cache (phase 5's two waves: prefix hits and a copy-on-write at
    128 KB leaf pages); then the layer-0 comparison (``check_layer0_parallel``)
    and Model.apply at S 2048. rmsnorm_matmul never launches (LayerNorm). ->
    launches by run."""
    cfg = cut_config(PYTHIA)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    table = model.build_table(params)
    torch.cuda.synchronize()
    log(f'[pythia] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, '
        f'{cfg.num_heads}H/{cfg.num_kv_heads}KV, {cfg.block_type} block, '
        f'{cfg.norm}, {cfg.act} MLP {cfg.d_ff}, vocab {cfg.vocab_size}; '
        f'weights {tree_bytes(params) / 1e9:.2f} GB + table '
        f'{tuple(table.table.shape)} {str(table.table.dtype)[6:]} '
        f'({nbytes(table.table) / 1e9:.2f} GB, layout {table.layout}) made '
        f'on the card in {time.perf_counter() - t0:.1f}s')
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        64, 201))).astype(np.int32) for _ in range(4)]
    out = {}
    for run, tab in (('pythia', table), ('pythia_baseline', None)):
        out[run] = serve_dense(model, params, tab, prompts, rng, False)
        assert out[run][0]['rmsnorm_matmul'] == 0, out[run][0]
        free()
    log(f'[engine baseline] {cfg.name}: greedy tokens equal to the table '
        f'run\'s: {token_share(out["pythia_baseline"][1], out["pythia"][1])}'
        ' (reported, not checked)')
    phases = {run: v[0] for run, v in out.items()}
    system = rng.integers(3, cfg.vocab_size, size=256).astype(np.int32)
    reqs = glm_requests(cfg, rng, system, 0)
    warm = rng.integers(3, cfg.vocab_size, size=40).astype(np.int32)
    want = serve_waves(model, params, table, 'pythia_paged',
                       'paged_attention', False, system, warm, reqs, rng,
                       'cuda', torch.bfloat16, eager=True)[4]
    launches, _, pool_bytes, *_ = serve_waves(
        model, params, table, 'pythia_paged', 'paged_attention', False,
        system, warm, reqs, rng, 'cuda', torch.bfloat16, expect=want)
    del want
    assert launches['rmsnorm_matmul'] == 0, launches
    log(f'[pythia_paged] KV pool {pool_bytes / 2**30:.2f} GiB at rest beside '
        f'{tree_bytes(params) / 2**30:.2f} GiB of weights and a '
        f'{nbytes(table.table) / 2**30:.2f} GiB table')
    phases['pythia_paged'] = launches
    free()
    check_layer0_parallel(model, params, table, rows)
    phases.update(phase_apply(model, params, table, PYTHIA_APPLY_SEQ,
                              'pythia'))
    return phases


def check_layer0_parallel(model, params, table, rows,
                          counts=PYTHIA_LAYER0_COUNTS) -> None:
    """The paper's layer-0 comparison for a parallel block on the model's
    own weights and table: baseline = the embedding rows + LN1 + Q/K/V +
    LN2 + FFN + skip (``blocks.block_preproj``: torch ops, as JAX leaves
    them to XLA), precomputed = ``embed_gather`` of the table's rows (the
    same four pieces); the gathered rows against the baseline's within
    RMS_TOL (the table was built in chunks of 8192 rows, so its products
    may round otherwise). Ids rotate over 16 sets; the weights (369 MB at
    pythia-6.9b) exceed the 50 MB L2, so every replay reads them from
    device memory. The times go to ``rows['embed_gather']['layer0']``."""
    cfg = model.cfg
    plan = layer_plan(cfg)
    lay0 = params['backbone']['layer0']
    embed, rows_tab = params['embed']['table'], table.table
    d, W, es = cfg.d_model, rows_tab.shape[1], embed.element_size()
    attn = lay0['attn']
    moe = 'moe' in lay0
    w_bytes = tree_bytes([lay0['ln1'], lay0['ln2'],
                          lay0['moe' if moe else 'ffn']]) \
        + nbytes(attn['wq']['w'], attn['wk']['w'], attn['wv']['w'])
    if moe:     # a row's products: Q/K/V, the router, its top-k experts
        m = cfg.moe
        ops = 2 * d * (cfg.q_size + 2 * cfg.kv_size + m.num_experts
                       + 3 * m.top_k * m.d_ff_expert)
    else:
        ops = 2 * d * (cfg.q_size + 2 * cfg.kv_size + 2 * cfg.d_ff)
    ffn_text = (f'LN2 + MoE ({cfg.moe.num_experts} experts, top-'
                f'{cfg.moe.top_k}, capacity dispatch)' if moe
                else 'LN2 + FFN')

    def preproj(ids, drops=None):
        pieces, dr = block_preproj(lay0, embed[ids.long()][None], cfg,
                                   plan.kinds[0], plan.use_moe[0],
                                   return_drops=True)
        if drops is not None:
            drops.append(int(dr))
        return torch.cat([pieces[nm] for nm, _ in table.layout], dim=-1)[0]
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    out = {}
    for n in counts:
        ids = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device='cuda', dtype=torch.int32)
               for _ in range(16)]
        drops = []
        want = preproj(ids[0], drops)
        got = embed_gather(rows_tab, ids[0])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # an MoE's capacity is capacity(N) here and capacity(8192) in the
        # table's build: the rows agree only where neither dropped a slot
        if not drops[0]:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=RMS_TOL, rtol=RMS_TOL)
        del got, want
        calls = [0]

        def pick():
            calls[0] += 1
            return ids[calls[0] % 16]
        it = (20, 5) if n <= 64 else (3, 3)
        base = time_ms(lambda: preproj(pick()), *it)
        pre = time_ms(lambda: embed_gather(rows_tab, pick()), *it)
        base_bytes = n * d * es + w_bytes
        pre_bytes = n * W * es
        b_ms, by = bound(base_bytes + n * W * es, n * ops, torch.bfloat16)
        log(f'[layer0] {cfg.name} N={n}: baseline (embedding rows + LN1 + '
            f'Q/K/V + {ffn_text} + skip, torch ops) {base:.4f} ms, '
            f'{base_bytes} bytes read, bound {b_ms:.4f} ms ({by}); '
            f'precomputed (embed_gather of {W}-wide rows) {pre:.4f} ms, '
            f'{pre_bytes} bytes read; baseline / precomputed '
            f'{base / pre:.1f}x, bytes {base_bytes / pre_bytes:.1f}x; rows '
            + (f'agree, max |diff| {err:.3g} (tol {RMS_TOL})' if not drops[0]
               else f'not compared: the baseline MoE dropped {drops[0]} '
               f'slots at capacity({n}) (max |diff| {err:.3g})'))
        out[n] = dict(baseline_ms=base, precomputed_ms=pre,
                      baseline_bound_ms=b_ms, max_abs_diff=err,
                      baseline_moe_drops=drops[0])
        del ids
    rows['embed_gather'].setdefault('layer0', {})[cfg.name] = out
    free()


# ----------------------------------------------------------------- phase 8
def pressure_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    system = rng.integers(3, cfg.vocab_size, size=40).astype(np.int32)
    tails = [rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
             for n in (20, 7, 31, 12, 25, 3)]
    return [np.concatenate([system, t]) for t in tails]


def ring_prompts(cfg, seed):
    """``pressure_prompts`` and, for ring pages with snapshots, the first
    and third prompts again (prefix hits at their snapshots)."""
    prompts = pressure_prompts(cfg, seed)
    return prompts + [prompts[0].copy(), prompts[2].copy()]


def phase_pressure(device='cuda') -> dict:
    """glm4-9b's smoke config, and then mistral-7b's (ring pages with
    snapshots), fp32, paged, without the fused gather: a pool too small
    for the slots preempts, and the tokens equal an unpressured run's.
    -> glm4's launches."""
    launches = pressure_run('glm4_9b', device)
    pressure_run('mistral_7b', device)
    return launches


def pressure_run(arch, device) -> dict:
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(SEED, device=device, dtype=torch.float32)
    table = model.build_table(params)
    ring = arch == 'mistral_7b'
    prompts = ring_prompts(cfg, SEED + 2) if ring \
        else pressure_prompts(cfg, SEED + 2)
    out, launches = {}, {}
    for num_pages in (None, 8):
        eng = ServingEngine(model, params, max_slots=3, max_seq=128,
                            precomputed=table, seed=SEED, chunk_size=8,
                            fused_gather_rope=False, prefix_cache=True,
                            page_size=16, num_pages=num_pages,
                            attn_backend='cuda', dtype=torch.float32,
                            device=device)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        zero_launches()
        for r in reqs:
            eng.submit(r)
        report = eng.run()
        launches = read_launches()
        assert all(r.status is RequestStatus.FINISHED for r in reqs), \
            [(r.uid, r.status, r.error) for r in reqs]
        out[num_pages] = ([r.generated for r in reqs], report['preemptions'],
                          eng.num_pages, eng.kv.hits)
    (base, pre0, np0, hits0), (tok, pre, np1, hits) = out[None], out[8]
    assert pre0 == 0 and pre > 0, (pre0, pre)
    assert tok == base, 'tokens changed under pool pressure'
    for name in ('embed_gather', 'fused_page_write', 'paged_attention'):
        assert launches[name] > 0, f'{name} never launched under pressure'
    assert launches['gather_rope'] == 0
    if ring:
        assert hits0 > 0 and launches['cow_page_copy'] == 0, \
            (hits0, launches)
    log(f'[pressure] {cfg.name} fp32, 3 slots, {len(prompts)} requests: '
        f'{pre} preemptions with {np1} pages (none with {np0}); greedy '
        f'tokens equal ({sum(map(len, tok))} tokens); prefix hits {hits0} '
        f'and {hits}' + (f' (ring pages: Sc {eng._sc_ring}, snapshots)'
                         if ring else '') + f'; launches '
        f'{json.dumps(launches)}')
    return launches


# ----------------------------------------------------------------- phase 9
class ReferenceAttendKernelWrites(ReferenceBackend):
    """The reference attend with the kernel write path (fused_page_write,
    deferred clears, cow_page_copy): isolates the maintenance kernels, so
    its pool must equal the plain write path's bit for bit."""
    name = 'reference+kernel-writes'
    fused_maintenance = True


def phase_consistency(device='cuda') -> None:
    """The smoke configs with fp32 and then int8 KV caches; deepseek's
    tokens (latent caches, which ignore kv_quant) must not change."""
    ds_tokens = {kv_quant: consistency(kv_quant, device)
                 for kv_quant in (False, True)}
    assert ds_tokens[True] == ds_tokens[False], \
        'deepseek tokens changed with kv_quant=True'
    log(f'[consistency int8] {DS} fp32: kv_quant=True gives the tokens of '
        f'kv_quant=False ({sum(map(len, ds_tokens[True]))} tokens)')


def consistency(kv_quant: bool, device) -> list:
    """-> deepseek's dense reference tokens."""
    tag = '[consistency int8]' if kv_quant else '[consistency]'
    cfg = get_smoke_config('mistral_7b')
    model = Model(cfg)
    params = model.init(SEED, device=device, dtype=torch.float32)
    table = model.build_table(params)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 23, 40, 11, 17)]
    out = {}
    for backend in ('cuda', 'reference'):
        eng = ServingEngine(model, params, max_slots=3, max_seq=96,
                            precomputed=table, seed=SEED, chunk_size=4,
                            fused_gather_rope=True, attn_backend=backend,
                            kv_quant=kv_quant, dtype=torch.float32,
                            device=device)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        out[backend] = [r.generated for r in reqs]
    assert out['cuda'] == out['reference'], out
    log(f'{tag} {cfg.name} fp32: greedy tokens of the cuda and '
        f'reference backends equal ({sum(map(len, out["cuda"]))} tokens, '
        f'{len(prompts)} requests)')

    for name in ('glm4_9b', DS, 'mistral_7b'):
        cfg = get_smoke_config(name)
        model = Model(cfg)
        params = model.init(SEED, device=device, dtype=torch.float32)
        table = model.build_table(params)
        ring = name == 'mistral_7b'         # ring pages with snapshots
        if ring:
            prompts = ring_prompts(cfg, SEED + 3)
        else:
            prompts = pressure_prompts(cfg, SEED + 3)
            prompts.append(prompts[0][:44].copy())  # stops inside a page

        def serve(backend, num_pages, mesh=None, **opts):
            kw = dict(prefix_cache=True, page_size=16, num_pages=num_pages) \
                if num_pages else {}
            eng = ServingEngine(model, params, max_slots=3, max_seq=128,
                                precomputed=table, seed=SEED, chunk_size=8,
                                fused_gather_rope=True, attn_backend=backend,
                                kv_quant=kv_quant, dtype=torch.float32,
                                mesh=mesh, device=device, **kw, **opts)
            reqs = [Request(uid=i, prompt=p, max_new_tokens=12)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            assert all(r.status is RequestStatus.FINISHED for r in reqs)
            assert eng._pending_clear == []
            return [r.generated for r in reqs], eng

        tokens, _ = serve('reference', 0)
        if name == DS:
            ds_tokens = tokens
        # 16 pages: prefix hits and a copy-on-write (ring: hits at
        # snapshots, no copy-on-write); 12: preemptions as well
        for num_pages in (16, 12):
            runs = {'paged cuda': serve('cuda', num_pages),
                    'paged reference': serve('reference', num_pages),
                    'paged reference+kernel writes':
                        serve(ReferenceAttendKernelWrites(), num_pages)}
            if not kv_quant:
                # packed prefill and the async loop; on 16 pages also under
                # a page steal (JAX's seeded schedule: 10 pages at tick 3,
                # back at tick 9), on 12 through the preemptions
                fast = dict(pack_prefill=True, async_loop=True)
                runs['paged cuda async+packed'] = serve('cuda', num_pages,
                                                        **fast)
                if num_pages == 16:
                    steal = ScriptedFaults(steal_pages={3: 10},
                                           restore_pages_at=(9,))
                    runs['paged cuda async+packed, steal'] = serve(
                        'cuda', num_pages, fault_injector=steal, **fast)
                    steal.release_stolen(runs[
                        'paged cuda async+packed, steal'][1])
            for label, (tok, _) in runs.items():
                assert tok == tokens, f'{label} ({num_pages} pages): tokens ' \
                    'differ from dense reference'
            eng = runs['paged cuda'][1]
            if num_pages == 16:
                assert eng.kv.hits > 0 and (eng.cow_copies == 0 if ring
                                            else eng.cow_copies > 0)
            else:
                assert eng.preemptions > 0
            fast = {label: (e.preemptions, e.kv.hits, sorted(
                k for k in e.programs if k[0] == 'packed'))
                for label, (_, e) in runs.items() if 'async' in label}
            if fast:
                assert num_pages == 16 or all(
                    p > 0 for p, _, _ in fast.values()), fast
                log(f'{tag} {cfg.name} fp32 paged, {num_pages} pages: '
                    + '; '.join(f'{label}: greedy tokens of the dense '
                                f'reference, {p} preemptions, {h} prefix '
                                f'hits, packed programs {keys}'
                                for label, (p, h, keys) in fast.items()))
            plain = runs['paged reference'][1]._pools
            for label, every_leaf in (('paged reference+kernel writes', True),
                                      ('paged cuda', False)):
                pools = runs[label][1]._pools
                for li, ((ca, _), (cb, _)) in enumerate(zip(plain, pools)):
                    assert sorted(ca) == sorted(cb)
                    for nm in ca:
                        # layers past 0 store K/V (latents) computed from
                        # the attention output, which the cuda kernel
                        # matches within KERNEL_TOL, not bitwise
                        if every_leaf or li == 0 or nm == 'pos':
                            assert torch.equal(ca[nm], cb[nm]), \
                                (label, num_pages, li, nm)
            leaves = sorted(plain[0][0])
            log(f'{tag} {cfg.name} fp32 paged, {num_pages} pages '
                + (f'(ring pages, Sc {eng._sc_ring}; {eng.kv.hits} prefix '
                   f'hits at snapshots, ' if ring else '(')
                + f'{eng.cow_copies} copy-on-write, {eng.preemptions} '
                f'preemptions): greedy tokens of paged cuda, paged reference '
                f'and dense reference equal ({sum(map(len, tokens))} tokens); '
                f'pool leaves {leaves} after the kernel write path bitwise '
                'equal to the plain write path on every layer; paged cuda vs '
                'reference pools bitwise on layer 0 and every position leaf')
            # the mesh engine: MLA (deepseek) falls back to one-device
            # attends; 12 pages preempt under the mesh too
            for spec in {'glm4_9b': ('2x2', '1x2'), DS: ('2x2',)}.get(
                    name, ()):
                mesh = card_mesh(spec)
                n0 = sharded_paged_attention.launches
                tok, eng = serve('cuda', num_pages, mesh)
                assert tok == tokens, f'mesh {spec} ({num_pages} pages): ' \
                    'tokens differ from dense reference'
                assert eng.cow_copies > 0 if num_pages == 16 \
                    else eng.preemptions > 0
                split = sharded_paged_attention.launches - n0
                assert (split > 0) == (cfg.mla is None), split
                log(f'{tag} {cfg.name} fp32 paged, {num_pages} pages, '
                    f'{mesh_text(mesh)}: greedy tokens of the dense '
                    f'reference ({eng.cow_copies} copy-on-write, '
                    f'{eng.preemptions} preemptions; {split} shard '
                    'launches of sharded_paged_attention'
                    + (', MLA attends unsharded)' if cfg.mla else ')'))
    return ds_tokens


# ---------------------------------------------------------------- phase 10
# gemma3-27b's pool, cut from the engine's default of 1797 pages (4 slots x
# (128 linear + 65 ring pages) + 8 x 128): a page holds 16 tokens of all 62
# layers, 8.1 MB in bf16, and 50.3 GiB of weights, the 6.6 GiB table and
# the chat's snapshots (0.40 GiB each) leave no room for 14.6 GB of pool;
# 768 pages still hold the four slots' rings and the chat's linear pages
GEMMA27_PAGES = 768


GEMMA_SYSTEM = 256
GEMMA_TAILS = ((9, 120, 77, 40), (23, 64, 100, 31))


def gemma_traffic(cfg):
    """Two waves of 4 requests on a 256-token system prompt, each with a
    tail of its own (``GEMMA_TAILS``) and 16 new tokens, and a chat's first
    turns: 4 prompts of 1100-1300 tokens, past both gemma3 windows (512,
    1024). Under snapshots a prompt publishes at the last page boundary
    before its final token, so wave 1's 9-token tail puts a snapshot at the
    system prompt's end (256) and each request of wave 2 hits there. Such a
    hit always ends on a page boundary: no request copies on write."""
    rng = np.random.default_rng(SEED + 9)
    system = rng.integers(3, cfg.vocab_size, size=GEMMA_SYSTEM).astype(
        np.int32)
    uid = itertools.count(200)
    waves = tuple([Request(uid=next(uid), prompt=np.concatenate(
        [system, rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)]),
        max_new_tokens=16) for n in tails] for tails in GEMMA_TAILS)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        1100, 1301))).astype(np.int32) for _ in range(RING_SLOTS)]
    return waves, prompts


def split_calls(fn):
    """``fn()`` with the C entry points of paged_attention.cu counted:
    template and split kernels of the dense and int8 forms (a graph
    replay calls none; a capture or an eager step calls each form it
    runs). -> (fn's result, calls by entry point)."""
    lib = build.load('paged_attention')
    names = ('paged_attention', 'paged_attention_quant',
             'paged_attention_split', 'paged_attention_quant_split')
    counters = [count_calls(lib, nm) for nm in names]
    try:
        out = fn()
    finally:
        for c in counters:
            c.undo()
    return out, {c.name: c.calls for c in counters}


def qk_norm_ms(cfg, params, tag) -> None:
    """Device ms that ``qk_norm`` (per-head RMSNorm of q and k, plain
    PyTorch) takes a layer at the engine's step shapes (4 slots, T 1 and
    16), and a step: every layer but layer 0, whose q and k come from the
    table; the kernels a layer are a CUDA graph's nodes."""
    p = params['backbone']['layer0']['attn']
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    parts = []
    for T in (1, 16):
        q, k = (torch.randn(RING_SLOTS, T, n, device='cuda', generator=gen,
                            dtype=torch.bfloat16)
                for n in (cfg.q_size, cfg.kv_size))

        def fn():
            return A.qk_normalize(p, q, k, cfg)
        ms = time_ms(fn)
        parts.append(f'T {T}: {device_kernels(fn)} kernels, {ms:.4f} ms a '
                     f'layer, {ms * (cfg.num_layers - 1):.3f} ms a step')
    log(f'[{tag}] qk_norm (plain PyTorch, q and k of {cfg.num_layers - 1} '
        f'layers a step; layer 0 from the table), {RING_SLOTS} slots: '
        + '; '.join(parts))


def phase_gemma(arch, tag, rows, num_pages=None, runs=('int8',)) -> dict:
    """``arch`` (gemma3-27b or gemma3-1b) at full width and its DEPTHS depth
    (gemma3-1b: full depth) on seeded random bf16 weights: the table (qk_norm
    and the sqrt(d) embedding scale folded in), the fused gather-RoPE at layer
    0's theta (10k: layer 0 is local), the cuda backend, 4 slots, chunk 16,
    page 16, max_seq 2048; the paged pool holds ring pages for the local layers
    and linear pages for the global ones, with the radix cache and snapshots.
    Each run serves ``gemma_traffic`` through :func:`serve_ring` (two waves on
    a system prompt, the second hitting its snapshot, then the two-turn chat
    whose second turns hit the snapshots): bf16 first inside
    ``_eager_steps()``, then replayed and held bitwise against it, then the
    extra ``runs`` ('int8'; 'async': the async loop, the bf16 run's tokens).
    Every attend takes the split kernel (dense or int8 form) and the template
    never (``split_calls``). Then the cost of ``qk_norm`` a step
    (:func:`qk_norm_ms`), the layer-0 comparison and Model.apply at S 4096. ->
    launches by run."""
    cfg = cut_config(arch)
    model = Model(cfg)
    plan = layer_plan(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    table = model.build_table(params)
    torch.cuda.synchronize()
    log(f'[{tag}] {cfg.name}: {cfg.num_layers} layers (layer 0 '
        f'{plan.kinds[0]}, {plan.reps} x {plan.slots}, tail {plan.n_tail}), '
        f'd {cfg.d_model}, {cfg.num_heads}H/{cfg.num_kv_heads}KV x '
        f'{cfg.head_dim}, window {cfg.window}, RoPE theta local '
        f'{cfg.layer_rope_theta("local"):g} / global '
        f'{cfg.layer_rope_theta("global"):g}, qk_norm, sqrt(d) embedding '
        f'scale, {cfg.act} MLP {cfg.d_ff}, tied head, vocab '
        f'{cfg.vocab_size}; weights {tree_bytes(params) / 2**30:.2f} GiB + '
        f'table {tuple(table.table.shape)} {str(table.table.dtype)[6:]} '
        f'({nbytes(table.table) / 2**30:.2f} GiB, layout {table.layout}) '
        f'made on the card in {time.perf_counter() - t0:.1f}s')
    waves, prompts = gemma_traffic(cfg)
    if num_pages is not None:
        lin = SPLIT_SEQ // RING_PS
        ring = -(-A.cache_len(cfg.window, SPLIT_SEQ, 16) // RING_PS)
        log(f'[{tag}] pool cut to {num_pages} pages from the engine\'s '
            f'default {1 + RING_SLOTS * (lin + ring) + 8 * lin} (widths '
            'unchanged)')

    def serve(run, kv_quant, **kw):
        (launches, tokens, digest), calls = split_calls(lambda: serve_ring(
            model, params, table, prompts, run, kv_quant, 'cuda',
            max_seq=SPLIT_SEQ, num_pages=num_pages, pre_waves=waves, **kw))
        split = 'paged_attention_quant_split' if kv_quant \
            else 'paged_attention_split'
        assert calls[split] > 0 and calls['paged_attention'] == 0 \
            and calls['paged_attention_quant'] == 0, (run, calls)
        log(f'[{run}] attends by form (host calls: captures and eager '
            f'steps): {json.dumps(calls)}; the template kernel never')
        if digest is not None:      # a digest holds the engine's state
            digest['leaves'] = [x.cpu() for x in digest['leaves']]
        return launches, tokens, digest
    out = {}
    base = f'{tag}_paged'
    want = serve(base, False, eager=True)[2]
    free()
    out[base] = serve(base, False, expect=want)
    del want
    free()
    if 'int8' in runs:
        out[base + '_int8'] = serve(base + '_int8', True)
        free()
        log(f'[{base}_int8] greedy tokens equal to the bf16 run\'s: '
            f'{token_share(out[base + "_int8"][1], out[base][1])} (reported, '
            'not checked)')
    if 'async' in runs:
        out[base + '_async'] = serve(base + '_async', False, async_loop=True)
        assert out[base + '_async'][1] == out[base][1], \
            f'{base}_async: greedy tokens differ from [{base}]'
        log(f'[{base}_async] greedy tokens '
            f'({sum(map(len, out[base][1]))}) equal to [{base}]\'s')
        free()
    phases = {run: v[0] for run, v in out.items()}
    qk_norm_ms(cfg, params, tag)
    check_layer0(model, params, table, LAYER0_COUNTS, rows)
    phases.update(phase_apply(model, params, table, 4096, tag))
    del params, table, model
    free()
    return phases


# ---------------------------------------------------------------- phase 12
# (config, tag, layers): full width, depth the only cut, to fit one H100
# beside pools, tables and the eager twins' states: mixtral-8x7b and its
# parallel twin at 8 of 32 layers (23.2 GB of bf16 layers; 8, not 16, to
# keep the script near 10 minutes), llama3-405b at 4 of 126 (25.5 GB of
# layers + 8.4 GB of embedding and head + an 8.9 GB table)
BIG_MODELS = (('mixtral_8x7b', 'mixtral', 8),
              ('mixtral_8x7b_parallel', 'mixtral_par', 8),
              ('llama3_405b', 'llama3', 4))
BIG_APPLY_SEQ = 4096


def phase_big(arch, tag, depth, rows) -> dict:
    """``arch`` at full width and ``depth`` layers on seeded random bf16
    weights: the table (and, for a parallel MoE, the MoE token slots its
    build drops: chunks of 8192 rows without a lane mask, as JAX builds
    it), the read ratio of ``core.analysis.analyze`` at batch 1; the
    paged engine with the table and the fused gather-RoPE, bf16, first as
    an eager twin and then replayed and held bitwise against it, then
    without the table (its tokens' share reported): windowed configs
    (the Mixtrals) serve phase 4's two-turn chat on ring pages with
    snapshots (:func:`serve_ring`), the others phase 5's two waves on a
    256-token system prompt (:func:`serve_waves`, a copy-on-write); then
    layer 0 alone against the gather (N 1-4096: ``check_layer0``, or
    ``check_layer0_parallel`` for a parallel block, whose baseline runs
    LN2 and the whole MoE) and Model.apply at S 4096, baseline and table
    in turns. -> launches by run."""
    from repro_torch.core.analysis import analyze
    from repro_torch.core.precompute import build_precomputed_table
    from repro_torch.models.moe import capacity
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=depth)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init, t0 = time.perf_counter() - t0, time.perf_counter()
    table, build_drops = build_precomputed_table(params, cfg,
                                                 return_drops=True)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    an = analyze(full)          # layer 0's reads: the same at any depth
    ratio = an.reduction_factor(1, full.d_model)
    m = cfg.moe
    log(f'[{tag}] {cfg.name}: {depth} of {full.num_layers} layers (depth '
        f'the only cut), {cfg.block_type} block, d {cfg.d_model}, '
        f'{cfg.num_heads}H/{cfg.num_kv_heads}KV x {cfg.head_dim}, window '
        f'{cfg.window}, RoPE theta {cfg.rope_theta:g}, '
        + (f'MoE {m.num_experts} experts top-{m.top_k} of {m.d_ff_expert} '
           f'(capacity factor {m.capacity_factor})' if m else
           f'{cfg.act} MLP {cfg.d_ff}')
        + f', vocab {cfg.vocab_size}; weights '
        f'{tree_bytes(params) / 1e9:.2f} GB made on the card in '
        f'{t_init:.1f}s; table {tuple(table.table.shape)} '
        f'{str(table.table.dtype)[6:]} ({nbytes(table.table) / 1e9:.2f} GB, '
        f'layout {table.layout}) built in {t_table:.1f}s'
        + (f'; the build\'s MoE dropped {build_drops} token slots (chunks '
           f'of 8192 rows, capacity {capacity(8192, m)} a chunk)'
           if cfg.block_type == 'parallel' and m else '')
        + f'; analysis.analyze ({full.num_layers} layers): layer 0 reads '
        f'{an.reads_without_b1} elements at batch 1 without the table, '
        f'{an.reads_with_b1} with it: {ratio:.0f}x; net memory '
        f'{an.rel_memory_delta * 100:+.2f}% of the weights')
    out = {}
    run = f'{tag}_paged'
    if cfg.window:
        rng = np.random.default_rng(SEED + 4)
        prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
            4160, 4401))).astype(np.int32) for _ in range(RING_SLOTS)]

        def serve(tab, tag_, **kw):
            return serve_ring(model, params, tab, prompts, tag_, False,
                              'cuda', **kw)
    else:
        rng = np.random.default_rng(SEED)
        system = rng.integers(3, cfg.vocab_size, size=256).astype(np.int32)
        reqs = glm_requests(cfg, rng, system, 0)
        warm = rng.integers(3, cfg.vocab_size, size=40).astype(np.int32)

        def serve(tab, tag_, **kw):
            return serve_waves(model, params, tab, tag_, 'paged_attention',
                               False, system, warm, reqs, rng, 'cuda',
                               torch.bfloat16, **kw)
    # serve_ring and serve_waves: (launches, greedy tokens, ..., digest)
    want = serve(table, run, eager=True)[-1]
    free()
    out[run] = serve(table, run, expect=want)
    del want
    free()
    out[run + '_base'] = serve(None, run + '_base')
    free()
    log(f'[{run}_base] greedy tokens equal to the table run\'s: '
        f'{token_share(out[run + "_base"][1], out[run][1])} '
        '(reported, not checked)')
    phases = {k: v[0] for k, v in out.items()}
    del out
    if cfg.block_type == 'parallel':
        check_layer0_parallel(model, params, table, rows,
                              counts=LAYER0_COUNTS)
    else:
        check_layer0(model, params, table, LAYER0_COUNTS, rows)
    log(f'[layer0] {cfg.name}: analysis.analyze read ratio at batch 1 '
        f'{ratio:.0f}x ({an.reads_without_b1} / {an.reads_with_b1} '
        'elements), beside the times above')
    phases.update(phase_apply(model, params, table, BIG_APPLY_SEQ, tag))
    del params, table, model
    free()
    return phases


# ---------------------------------------------------------------- phase 13
# the recurrent and hybrid families at full width and depth: 4 slots,
# chunk 16, the cuda backend; xlstm-125m's dense engine at max_seq 512 and
# its paged one at 2048 (page 16), hymba-1.5b's dense engine at 2048
REC_SLOTS, REC_CHUNK = 4, 16
XLSTM_DENSE_SEQ = 512
REC_APPLY_SEQ = 2048
# the layer kinds that keep no attention cache
RECURRENT = ('mlstm', 'slstm')


def rec_engine(model, params, table, max_seq, **kw):
    """An engine of phase 13: 4 slots, chunk 16, the table (or None), the
    fused gather asked for (it falls back: layer 0 is no attention layer),
    the cuda backend, bf16 state."""
    eng = ServingEngine(model, params, max_slots=REC_SLOTS, max_seq=max_seq,
                        precomputed=table, seed=SEED, dtype=torch.bfloat16,
                        chunk_size=REC_CHUNK, fused_gather_rope=True,
                        attn_backend='cuda', device='cuda', **kw)
    assert not eng.fused_gather_rope and eng._graphs
    return eng


def copy_requests(reqs):
    return [Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in reqs]


def program_nodes(eng) -> dict:
    """Device kernels a step of each captured step shape: the nodes of a
    re-capture of its forward (which launches nothing: the counts are put
    back)."""
    counts = read_launches()
    nodes = {str(key): device_kernels(
        lambda: p._forward(eng._bucket_states(p.nb)))
        for key, p in sorted(eng.programs.items()) if p.graph is not None}
    for kern, n in zip(KERNELS, counts.values()):
        kern.launches = n
    return nodes


def serve_rec(eng, tag, waves, *, warm=None, eager=False, expect=None,
              hits=None, score_len=40) -> dict:
    """``waves`` on ``eng``, each run to its end: a list of Requests, or a
    function of the previous wave's (finished) requests that makes them.
    ``warm`` (a prompt): a 2-token request first, outside the measured run
    (cuBLAS handles, the step shapes' graphs). With ``eager`` every step
    runs inside ``_eager_steps()`` and no profile; ``expect`` (an eager
    run's digest) holds tokens, ``score()`` logits and every state leaf
    bitwise against it. ``hits``: each request's prefix-hit tokens, asserted.
    Checks: every request FINISHED with its tokens; one embed_gather a step
    with the table, none without; paged_attention once per attention layer
    and step; no other kernel (no page write or copy, no fused gather). ->
    launches, tokens, the requests, the digest (its leaves on the host
    after an eager run, which the same engine may serve again), steps,
    ms/step, tok/s, the programs' device span a step and, replayed, the
    device kernels a step of each captured step shape."""
    cfg = eng.model.cfg
    attn_layers = sum(k not in RECURRENT for k in layer_plan(cfg).kinds)
    reqs, prev, waves_s = [], None, []
    if eager:
        tag += ' eager'
    with steps_mode(eager):
        if warm is not None:
            eng.submit(Request(uid=-1, prompt=warm, max_new_tokens=2))
            eng.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = eng.steps
        zero_launches()
        with program_spans() as events:
            t_all = time.perf_counter()
            for wave in waves:
                wave = wave(prev) if callable(wave) else wave
                t0 = time.perf_counter()
                for r in wave:
                    eng.submit(r)
                eng.run()
                torch.cuda.synchronize()
                waves_s.append(time.perf_counter() - t0)
                reqs += wave
                prev = wave
            dt = time.perf_counter() - t_all
    launches = read_launches()
    steps = eng.steps - steps0
    for r in reqs:
        assert r.status is RequestStatus.FINISHED, (tag, r.uid, r.status,
                                                    r.error)
        assert len(r.generated) == r.max_new_tokens, (r.uid,
                                                      len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    want = {'embed_gather': steps if eng.precomputed is not None else 0,
            'paged_attention': attn_layers * steps}
    assert all(launches[k] == want.get(k, 0) for k in launches), \
        (tag, launches, want)
    if hits is not None:
        assert [r.prefix_hit_tokens for r in reqs] == hits, \
            (tag, [r.prefix_hit_tokens for r in reqs], hits)
    stats = eng.stats(reqs)
    span_ms = sum(a.elapsed_time(b) for a, b in events)
    ttft = [r.first_token_t - r.submit_t for r in reqs]
    log(f'[{tag}] {len(reqs)} requests (prompts '
        f'{[len(r.prompt) for r in reqs]}), {stats["tokens"]} new tokens in '
        f'{dt:.3f}s -> {stats["tokens"] / dt:.1f} tok/s; {steps} steps '
        f'({dt / steps * 1e3:.2f} ms/step); wave seconds '
        f'{[round(w, 3) for w in waves_s]}; mean TTFT {np.mean(ttft):.3f}s; '
        f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
        + span_text(events, dt, steps))
    if eng.paged:
        n_snap, snap_bytes = snapshots_held(eng)
        log(f'[{tag}] prefix hits {stats["prefix_hits"]}, misses '
            f'{stats["prefix_misses"]}, hit tokens '
            f'{stats["prefix_hit_tokens"]} (per request '
            f'{[r.prefix_hit_tokens for r in reqs]}), copy-on-write '
            f'{stats["cow_copies"]}, pages in use {stats["pages_in_use"]} '
            f'(no page leaves: {len(eng._pools)} pools); snapshots held '
            f'{n_snap} ({snap_bytes} bytes, '
            f'{snap_bytes / max(n_snap, 1) / 2**20:.2f} MiB each)')
    log(f'[{tag}] launches {json.dumps(launches)} over {steps} steps '
        f'(embed_gather {"one" if eng.precomputed is not None else "none"} '
        f'a step, paged_attention {attn_layers} a step, no page kernel); '
        'all requests FINISHED with their tokens (finite logits)')
    tokens = [r.generated for r in reqs]
    with steps_mode(eager):
        scores = eng.score([reqs[0].prompt[:score_len]])
    digest = replay_digest(eng, tokens, scores)
    if eager:                   # the engine may serve again: keep copies
        digest['leaves'] = [x.cpu() for x in digest['leaves']]
    if expect is not None:
        check_replay(f'[{tag}]', eng, digest, expect)
    out = dict(launches=launches, tokens=tokens, requests=reqs,
               digest=digest, steps=steps, ms_step=dt / steps * 1e3,
               tok_s=stats['tokens'] / dt, span_ms=span_ms / steps)
    if not eager:
        log_programs(f'[{tag}]', eng)
        out['nodes'] = program_nodes(eng)
        log(f'[{tag}] device kernels a step by captured step shape '
            f'{json.dumps(out["nodes"])}')
    return out


def rec_model(arch, tag):
    """``arch`` at full width and depth on seeded random bf16 weights and
    its table; logs the config, the weights, the table and
    core.analysis's layer-0 read ratio at batch 1. -> (config, model,
    params, table, ratio)."""
    from repro_torch.core.analysis import analyze
    cfg = get_config(arch)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    table = model.build_table(params)
    torch.cuda.synchronize()
    t_made = time.perf_counter() - t0
    plan = layer_plan(cfg)
    an = analyze(cfg)
    ratio = an.reduction_factor(1, cfg.d_model)
    s = cfg.ssm
    log(f'[{tag}] {cfg.name}: {cfg.num_layers} layers (layer 0 '
        f'{plan.kinds[0]}, {plan.reps} x {plan.slots}, tail {plan.n_tail}), '
        f'd {cfg.d_model}, positions {cfg.pos}, ssm heads '
        f'{s.num_ssm_heads}, conv {s.conv_kernel}'
        + (f', expand {s.expand}' if cfg.arch_class == 'ssm' else
           f', {cfg.num_heads}H/{cfg.num_kv_heads}KV x {cfg.head_dim}, '
           f'window {cfg.window}, state {s.state_dim}, '
           f'{cfg.num_meta_tokens} meta tokens, {cfg.act} MLP {cfg.d_ff}')
        + f', tied head, vocab {cfg.vocab_size}; weights '
        f'{tree_bytes(params) / 2**30:.3f} GiB + table '
        f'{tuple(table.table.shape)} ({nbytes(table.table) / 2**30:.3f} GiB, '
        f'layout {table.layout}) made on the card in {t_made:.1f}s; '
        f'analysis.analyze: layer 0 reads {an.reads_without_b1} elements at '
        f'batch 1 without the table, {an.reads_with_b1} with it: '
        f'{ratio:.1f}x')
    return cfg, model, params, table, ratio


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def check_layer0_rec(model, params, table, ratio, counts=LAYER0_COUNTS):
    """Layer 0 alone at full width: the baseline (the embedding rows read,
    LN1 and the block's precomputable projections as torch ops:
    ``blocks.block_preproj``; no kernel of the port) against the table
    (embed_gather of the rows: one launch), every piece within RMS_TOL.
    Launches rotate over COLD_COPIES copies of layer 0's weights and 16 id
    sets, as :func:`check_layer0`. Beside the analysis ratio."""
    from repro_torch.core.analysis import eliminated_weights
    cfg = model.cfg
    kind = layer_plan(cfg).kinds[0]
    sets = [params['backbone']['layer0']] + [
        clone_tree(params['backbone']['layer0'])
        for _ in range(COLD_COPIES - 1)]
    embed, rows = params['embed']['table'], table.table
    es, d, W = embed.element_size(), cfg.d_model, rows.shape[1]
    w_elems = eliminated_weights(cfg)     # the projections' weights
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    for n in counts:
        ids = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device='cuda', dtype=torch.int32)
               for _ in range(16)]
        calls = [0]

        def pick():
            calls[0] += 1
            return calls[0] % COLD_COPIES, ids[calls[0] % 16]

        def baseline():
            i, t = pick()
            return block_preproj(sets[i], embed[t.long()][None], cfg, kind,
                                 False)

        def precomputed():
            return table.gather(pick()[1][None])
        zero_launches()
        want = block_preproj(sets[0], embed[ids[0].long()][None], cfg, kind,
                             False)
        assert all(v == 0 for v in read_launches().values())
        got = table.gather(ids[0][None])
        assert read_launches()['embed_gather'] == 1
        torch.cuda.synchronize()
        err = 0.0
        for nm, _ in table.layout:
            torch.testing.assert_close(got[nm].float(), want[nm].float(),
                                       atol=RMS_TOL, rtol=RMS_TOL)
            err = max(err, (got[nm].float() - want[nm].float()).abs().max()
                      .item())
        del got, want
        it = (20, 5) if n <= 64 else (3, 3)
        base, pre = time_ms(baseline, *it), time_ms(precomputed, *it)
        base_bytes = n * d * es + w_elems * es
        pre_bytes = n * W * es
        log(f'[layer0] {cfg.name} N={n}: baseline (embedding rows + LN1 + '
            f'the {kind} block\'s projections of '
            f'{[nm for nm, _ in table.layout][1:]} as torch ops, {w_elems} '
            f'weights) {base:.4f} ms, {base_bytes} '
            f'bytes read; precomputed (embed_gather of {W}-wide rows) '
            f'{pre:.4f} ms, {pre_bytes} bytes read; baseline / precomputed '
            f'{base / pre:.1f}x, bytes {base_bytes / pre_bytes:.1f}x; pieces '
            f'max |diff| {err:.3g} (tol {RMS_TOL}); analysis ratio at batch 1 '
            f'{ratio:.1f}x')
    del sets
    free()


def phase_apply_rec(model, params, table, tag,
                    order=('baseline', 'precomputed', 'precomputed',
                           'baseline')) -> dict:
    """Model.apply at full width, B 1 and REC_APPLY_SEQ tokens (hymba: after
    its 128 meta tokens), baseline and with the table in turns (``order``;
    xlstm's forward, a host-bound loop of ~5.7 s, runs once each): launches a
    forward (embed_gather once with the table; flash_attention once per
    attention layer, hymba's S + 128 being past the blocked threshold; nothing
    else: no rmsnorm_matmul, the hybrid block norms once for both branches as
    torch ops), ms of each forward, and the two runs' last 64 positions' logits
    against each other (APPLY_TOL). -> launches by run."""
    from repro_torch.models.attention import BLOCKED_THRESHOLD
    cfg = model.cfg
    S, M = REC_APPLY_SEQ, cfg.num_meta_tokens
    attn_layers = sum(k not in RECURRENT for k in layer_plan(cfg).kinds)
    flash = attn_layers if S + M >= BLOCKED_THRESHOLD else 0
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(3, cfg.vocab_size, size=S).astype(np.int32)
    batch = {'tokens': torch.from_numpy(prompt)[None].to('cuda')}
    last, launches, times = {}, {}, {'baseline': [], 'precomputed': []}
    for mode in order:
        pre = table if mode == 'precomputed' else None
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        logits, aux = model.apply(params, batch, precomputed=pre)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3)
        ln = read_launches()
        assert ln['flash_attention'] == flash, (mode, ln)
        assert ln['embed_gather'] == (pre is not None), (mode, ln)
        assert all(v == 0 for k, v in ln.items() if k not in (
            'flash_attention', 'embed_gather')), (mode, ln)
        if mode not in last:
            assert logits.shape == (1, S, cfg.vocab_size), logits.shape
            assert bool(torch.isfinite(logits).all()), f'{mode} logits'
            assert float(aux) == 0.0
            last[mode] = logits[0, -64:].float()
            launches[f'{tag}_apply' + ('_pre' if pre is not None else '')] \
                = ln
        del logits
    base, pre = last['baseline'], last['precomputed']
    mean = {m: float(np.mean(t)) for m, t in times.items()}
    log(f'[apply] {cfg.name} B=1 S={S}'
        + (f' (+ {M} meta tokens)' if M else '') + ': ms per forward '
        f'baseline {[round(t, 1) for t in times["baseline"]]} (mean '
        f'{mean["baseline"]:.1f}), precomputed '
        f'{[round(t, 1) for t in times["precomputed"]]} (mean '
        f'{mean["precomputed"]:.1f}); launches a forward: flash_attention '
        f'{flash}, embed_gather 1 with the table, nothing else')
    log(f'[apply] {cfg.name} last 64 positions, precomputed vs baseline '
        f'logits: {diff_text(pre, base)} (tol {APPLY_TOL}); '
        + logits_check(cfg, pre, base))
    free()
    return launches


def xlstm_prompts(cfg, seed, n=REC_SLOTS, lo=64, hi=201):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        lo, hi))).astype(np.int32) for _ in range(n)]


def phase_xlstm() -> dict:
    """xlstm-125m (12 layers alternating mLSTM / sLSTM, d 768, no
    positions) at full width and depth on seeded random bf16 weights: the
    table ([x, u1, u2, v, ifg], 5384 wide) and the analysis ratio; the
    dense engine with the table over phase 4's traffic (4 prompts of
    64-200 tokens, 16 new) as an eager twin and then replayed on the same
    engine, bitwise; the same traffic without the table; the paged engine
    with the radix cache over gemma_traffic's two waves on a 256-token
    system prompt (wave 2 hits wave 1's snapshot at 256: every recurrent
    and conv leaf's row of the slot), eager twin then a replayed engine,
    bitwise; the waves again with segment-packed prefill and with the
    async loop on fresh engines (tokens equal to the replayed run's);
    Model.apply at S 2048, baseline then table; layer 0 alone. No
    attention: no paged_attention and no page kernel ever launches, one
    embed_gather a step with the table. -> launches by run."""
    tag = 'xlstm'
    cfg, model, params, table, ratio = rec_model('xlstm_125m', tag)
    phases = {}
    prompts = xlstm_prompts(cfg, SEED + 3)
    warm = xlstm_prompts(cfg, SEED + 4, n=1, lo=20, hi=21)[0]

    def first():
        return [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
    eng = rec_engine(model, params, table, XLSTM_DENSE_SEQ)
    want = serve_rec(eng, f'{tag}_dense', [first()], warm=warm, eager=True)
    got = serve_rec(eng, f'{tag}_dense', [first()], warm=warm,
                    expect=want['digest'])
    del eng, want
    base = serve_rec(rec_engine(model, params, None, XLSTM_DENSE_SEQ),
                     f'{tag}_dense_base', [first()], warm=warm)
    log(f'[{tag}_dense_base] greedy tokens equal to the table run\'s: '
        f'{token_share(base["tokens"], got["tokens"])} (reported, not '
        'checked)')
    phases[f'{tag}_dense'] = got['launches']
    phases[f'{tag}_dense_base'] = base['launches']
    free()
    waves, _ = gemma_traffic(cfg)
    hits = [0] * len(waves[0]) + [GEMMA_SYSTEM] * len(waves[1])

    def paged_engine(**kw):
        eng = rec_engine(model, params, table, SPLIT_SEQ, prefix_cache=True,
                         page_size=RING_PS, **kw)
        assert eng._pools == [] and not eng._fused_maint \
            and eng._needs_snapshot and eng._sc_ring == 0
        return eng
    run = f'{tag}_paged'
    want = serve_rec(paged_engine(), run, [copy_requests(w) for w in waves],
                     warm=warm, eager=True, hits=hits)
    got = serve_rec(paged_engine(), run, [copy_requests(w) for w in waves],
                    warm=warm, expect=want['digest'], hits=hits)
    phases[run] = got['launches']
    del want
    free()
    for mode in ('packed', 'async'):
        out = serve_rec(paged_engine(**MODES[mode]), f'{run}_{mode}',
                        [copy_requests(w) for w in waves], warm=warm,
                        hits=hits)
        assert out['tokens'] == got['tokens'], \
            f'[{run}_{mode}] greedy tokens differ from [{run}]'
        scores = [np.frombuffer(b, np.float32) for b in
                  (out['digest']['scores'][0], got['digest']['scores'][0])]
        log(f'[{run}_{mode}] greedy tokens ({sum(map(len, out["tokens"]))})'
            f' equal to [{run}]\'s; score logits '
            + ('bitwise' if np.array_equal(*scores) else
               f'not bitwise, largest difference '
               f'{float(np.abs(scores[0] - scores[1]).max()):.3e}'))
        phases[f'{run}_{mode}'] = out['launches']
        free()
    phases.update(phase_apply_rec(model, params, table, tag,
                                  order=('baseline', 'precomputed')))
    check_layer0_rec(model, params, table, ratio)
    del params, table, model
    free()
    return phases


def phase_hymba() -> dict:
    """hymba-1.5b (32 hybrid layers: attention beside mamba heads, windowed
    1024 but for the global layers 0 and 16; 128 meta tokens) at full width
    and depth on seeded random bf16 weights: the table ([x, q, k, v, x_in,
    gate], 7040 wide) and the analysis ratio; ``prefix_cache=True`` refused
    with JAX's ValueError; the dense engine (max_seq 2048) with the table
    over a two-turn chat of 4 prompts of 1100-1400 tokens (past the
    window; turn 2 each prompt + its 16 tokens + 32 new): turn 1 as an
    eager twin, then on the same engine (its slots reset from the primed
    template) turn 1 replayed and held bitwise against it, then turn 2;
    the same slot serving one prompt twice (the same tokens); the chat
    without the table on an engine of its own; Model.apply at S 2048 (+
    128 meta tokens) in turns; layer 0 alone. paged_attention once per
    layer and step, one embed_gather a step with the table. Each engine
    primes the meta tokens once at construction (eagerly; timed). ->
    launches by run."""
    tag = 'hymba'
    cfg, model, params, table, ratio = rec_model('hymba_1_5b', tag)
    try:
        rec_engine(model, params, table, HYMBA_SEQ, prefix_cache=True,
                   page_size=RING_PS)
    except ValueError as err:
        log(f'[{tag}] prefix_cache=True refused (as JAX): {err}')
    else:
        raise AssertionError('hymba: prefix_cache=True did not raise')
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        1100, 1401))).astype(np.int32) for _ in range(REC_SLOTS)]
    extra = [rng.integers(3, cfg.vocab_size, size=32).astype(np.int32)
             for _ in range(REC_SLOTS)]
    warm = rng.integers(3, cfg.vocab_size, size=20).astype(np.int32)

    def turn1():
        return [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]

    def turn2(prev):
        return [Request(uid=10 + i, prompt=np.concatenate(
            [r.prompt, np.asarray(r.generated, np.int32), x]),
            max_new_tokens=16) for i, (r, x) in enumerate(zip(prev, extra))]

    def engine(tab):
        t0 = time.perf_counter()
        eng = rec_engine(model, params, tab, HYMBA_SEQ)
        torch.cuda.synchronize()
        log(f'[{tag}] engine with{"" if tab is not None else "out"} the '
            f'table: {cfg.num_meta_tokens} meta tokens primed into '
            f'{REC_SLOTS} slots x {cfg.num_layers} layers in '
            f'{time.perf_counter() - t0:.2f}s (eager one-token steps); '
            f'state {cache_bytes(eng) / 2**20:.1f} MiB')
        return eng
    phases = {}
    eng = engine(table)
    want = serve_rec(eng, f'{tag}_chat', [turn1()], warm=warm, eager=True)
    got = serve_rec(eng, f'{tag}_chat', [turn1()], warm=warm,
                    expect=want['digest'])
    del want
    got2 = serve_rec(eng, f'{tag}_chat_turn2', [turn2(got['requests'])])
    phases[f'{tag}_chat'] = got['launches']
    phases[f'{tag}_chat_turn2'] = got2['launches']
    reuse = serve_rec(eng, f'{tag}_reuse', [
        [Request(uid=50, prompt=prompts[0][:200], max_new_tokens=16)],
        lambda prev: [Request(uid=51, prompt=prompts[0][:200],
                              max_new_tokens=16)]])
    assert reuse['tokens'][0] == reuse['tokens'][1], \
        f'[{tag}_reuse] one slot served one prompt twice: tokens differ'
    log(f'[{tag}_reuse] slot 0 served the same 200-token prompt twice: the '
        'same 16 tokens (the slot reset copies the primed template)')
    del eng
    free()
    base = serve_rec(engine(None), f'{tag}_chat_base', [turn1(), turn2],
                     warm=warm)
    log(f'[{tag}_chat_base] greedy tokens equal to the table run\'s: '
        f'{token_share(base["tokens"], got["tokens"] + got2["tokens"])} '
        '(reported, not checked)')
    phases[f'{tag}_chat_base'] = base['launches']
    free()
    phases.update(phase_apply_rec(model, params, table, tag))
    check_layer0_rec(model, params, table, ratio)
    del params, table, model
    free()
    return phases



def main() -> None:
    t_start = time.perf_counter()

    def lap(name: str) -> None:
        log(f'[wall] {name} done at {time.perf_counter() - t_start:.1f}s')
    phase_device()
    phase_build()
    lap('phase 2 (build)')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    rows = {'embed_gather': check_embed_gather(gen),
            'gather_rope': check_gather_rope(gen)}
    check_paged_attention(gen)                 # mistral-7b shapes
    rows['paged_attention'] = check_paged_attention_pools(gen)
    rows['fused_page_write'] = check_fused_page_write(gen)
    rows['cow_page_copy'] = check_cow_page_copy(gen)
    floor = launch_floor_ms()
    for name in ('embed_gather', 'fused_page_write', 'cow_page_copy'):
        rows[name]['launch_floor_ms'] = floor
    rows['paged_attention_mla'] = check_paged_attention_mla(gen)
    check_mla_page_writes(gen)
    rows['paged_attention_quant'] = check_paged_attention_quant(gen)
    rows['fused_page_write'].update(check_quant_page_writes(gen))
    rows['fused_page_write']['pythia'] = check_page_writes_pythia(gen)
    rows['sharded_paged_attention'] = check_sharded_paged_attention(gen)
    for name, ring in check_ring_pages(gen, floor).items():
        rows[name]['mistral_ring'] = ring
    rows['flash_attention'] = check_flash_attention(gen)
    free()
    for arch in ('gemma3_1b', 'internvl2_1b'):
        for name, row in check_engine_kernels(gen, arch).items():
            rows[name][arch] = row
    rows['paged_attention']['hymba_1_5b'] = check_hymba_attends(gen)
    lap('phase 3 (kernels)')
    phases = phase_mistral(rows)
    free()
    lap('phase 4 (mistral)')
    phases.update(phase_paged(cut_config('glm4_9b'), 'glm4',
                              'paged_attention', int8=True, rows=rows,
                              apply_seq=4096, mesh_spec='2x2', observe=True,
                              wide=True, modes=GLM_MODES))
    free()
    lap('phase 5 (glm4)')
    phases.update(phase_paged(cut_config(DS), 'deepseek',
                              'paged_attention_mla', rows=rows,
                              apply_seq=4096,
                              modes=(('sync', False), ('packed', False))))
    free()
    lap('phase 6 (deepseek)')
    phases.update(phase_pythia(rows))
    free()
    lap('phase 7 (pythia)')
    phases['pressure'] = phase_pressure()
    phase_consistency()
    free()
    lap('phases 8-9 (pressure, consistency)')
    phases.update(phase_gemma('gemma3_27b', 'gemma27', rows,
                              num_pages=GEMMA27_PAGES,
                              runs=('int8', 'async')))
    phases.update(phase_gemma('gemma3_1b', 'gemma1', rows))
    free()
    lap('phase 10 (gemma3)')
    # phase 11: the encoder families
    phases.update(phase_whisper(rows))
    phases.update(phase_paged(get_config('internvl2_1b'), 'internvl',
                              'paged_attention', int8=True, rows=rows,
                              apply_seq=4096))
    free()
    lap('phase 11 (whisper, internvl2)')
    # phase 12: the MoE configs and llama3-405b at full width
    for arch, tag, depth in BIG_MODELS:
        phases.update(phase_big(arch, tag, depth, rows))
    lap('phase 12 (mixtral, llama3)')
    # phase 13: the recurrent and hybrid families at full width and depth
    phases.update(phase_xlstm())
    lap('phase 13 (xlstm)')
    phases.update(phase_hymba())
    lap('phase 13 (hymba)')
    # each kernel's launches on the engine path its row was measured for
    main_path = {'embed_gather': 'mistral', 'gather_rope': 'mistral',
                 'paged_attention': 'glm4', 'fused_page_write': 'glm4',
                 'cow_page_copy': 'glm4', 'paged_attention_mla': 'deepseek',
                 'paged_attention_quant': 'glm4_int8',
                 'rmsnorm_matmul': 'mistral_apply',
                 'flash_attention': 'mistral_apply',
                 'sharded_paged_attention': 'glm4_mesh'}
    sources = {name: f'src/repro_torch/csrc/{name}.cu' for name in rows}
    for form in ('paged_attention_mla', 'paged_attention_quant',
                 'sharded_paged_attention'):
        sources[form] = 'src/repro_torch/csrc/paged_attention.cu'

    replaces = {
        'embed_gather': 'src/repro/kernels/embed_gather.py:30',
        'gather_rope': 'src/repro/kernels/gather_rope.py:60',
        'paged_attention': 'src/repro/kernels/paged_attention.py:129',
        'paged_attention_mla': 'src/repro/kernels/paged_attention.py:129',
        'paged_attention_quant': 'src/repro/kernels/paged_attention.py:129',
        'fused_page_write': 'src/repro/kernels/paged_maintenance.py:131',
        'cow_page_copy': 'src/repro/kernels/paged_maintenance.py:217',
        'rmsnorm_matmul': 'src/repro/kernels/rmsnorm_qkv.py:34',
        'flash_attention': 'src/repro/kernels/flash_attention.py:80',
        'sharded_paged_attention': 'src/repro/kernels/paged_attention.py:210'}
    kernels = [dict(name=name, route='cuda',
                    source=sources[name],
                    replaces=replaces[name],
                    launches=phases[main_path[name]][name], **row,
                    launches_by_phase={ph: ln[name]
                                       for ph, ln in phases.items()})
               for name, row in rows.items()]
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
