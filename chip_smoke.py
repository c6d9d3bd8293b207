"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device   — requires a CUDA device; prints the card's name and power
              limit as nvidia-smi reports them.
2. build    — compiles the three CUDA kernels of the serving path from
              src/repro_torch/csrc (one nvcc per source, in parallel).
3. kernels  — holds each kernel against its plain PyTorch version on the
              card at mistral-7b full-width shapes, in bf16 and fp32, and
              times kernel, plain version, one PyTorch library call where
              one computes the same function, and the roofline bound.
4. engine   — serves mistral-7b at full width (random bf16 weights from a
              seed, precomputed table, chunk 16, fused gather→RoPE, the
              cuda attention backend): 4 requests, prompts of 64-200 tokens,
              16 new tokens each. Launch counters are zeroed just before
              and read just after; every kernel must have run.
5. consistency — the fp32 smoke config on the card: greedy tokens of the
              cuda backend equal those of the reference backend.

Ends with a ``{"kernels": [...]}`` line and, last, the device JSON line.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'src'))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.embed_gather import (embed_gather,  # noqa: E402
                                              embed_gather_plain)
from repro_torch.kernels.gather_rope import (gather_rope,  # noqa: E402
                                             gather_rope_plain)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    dense_as_pages, dense_identity_table, dense_page_split, page_validity,
    paged_attention, paged_attention_plain)
from repro_torch.models.attn_backend import KERNEL_TOL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (Request, RequestStatus,  # noqa: E402
                                        ServingEngine)

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
            torch.float32: 67e12}    # fp32 outside the tensor cores
KERNELS = [embed_gather, gather_rope, paged_attention]
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
def check_embed_gather(gen) -> dict:
    cfg = get_config('mistral_7b')
    V, W = cfg.vocab_size, cfg.precompute_row_width
    row = {}
    for dtype in (torch.bfloat16, torch.float32):
        table = torch.randn((V, W), generator=gen, device='cuda').to(dtype)
        for n in (1, 4, 64, 512):
            ids = torch.randint(0, V, (n,), generator=gen, device='cuda',
                                dtype=torch.int32)
            got = embed_gather(table, ids)
            want = embed_gather_plain(table, ids)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f'embed_gather {dtype} N={n}'
            id_sets = [torch.randint(0, V, (n,), generator=gen, device='cuda',
                                     dtype=torch.int32) for _ in range(16)]
            calls = [0]

            def pick():
                calls[0] += 1
                return id_sets[calls[0] % 16]
            ms = time_ms(lambda: embed_gather(table, pick()))
            plain = time_ms(lambda: embed_gather_plain(table, pick()))
            lib = time_ms(lambda: torch.index_select(table, 0, pick()))
            b_ms, by = bound(2 * n * W * table.element_size() + 4 * n, 0,
                             dtype)
            log(f'[kernel] embed_gather {str(dtype)[6:]} N={n} W={W}: '
                f'bitwise equal; kernel {ms:.4f} ms, plain {plain:.4f} ms, '
                f'index_select {lib:.4f} ms, bound {b_ms:.4f} ms ({by})')
            if dtype is torch.bfloat16 and n == 4:     # the decode step
                row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=lib)
        del table
    return row


def check_gather_rope(gen) -> dict:
    cfg = get_config('mistral_7b')
    V, W, hd = cfg.vocab_size, cfg.precompute_row_width, cfg.head_dim
    q_off, k_off = cfg.d_model, cfg.d_model + cfg.q_size
    segs = ((q_off, cfg.num_heads, hd), (k_off, cfg.num_kv_heads, hd))
    untouched = [(0, q_off), (k_off + cfg.kv_size, W)]
    row = {}
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        table = torch.randn((V, W), generator=gen, device='cuda').to(dtype)
        for n in (64, 512):
            ids = torch.randint(0, V, (n,), generator=gen, device='cuda',
                                dtype=torch.int32)
            pos = torch.randint(0, 32768, (n,), generator=gen, device='cuda',
                                dtype=torch.int32)
            pos[0] = 32767
            kw = dict(segs=segs, theta=cfg.rope_theta)
            got = gather_rope(table, ids, pos, **kw)
            want = gather_rope_plain(table, ids, pos, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            for a, b in untouched:
                assert torch.equal(got[:, a:b], table[ids.long(), a:b]), \
                    f'gather_rope changed columns {a}:{b}'
            ms = time_ms(lambda: gather_rope(table, ids, pos, **kw))
            plain = time_ms(lambda: gather_rope_plain(table, ids, pos, **kw))
            b_ms, by = bound(2 * n * W * table.element_size() + 8 * n, 0,
                             dtype)
            log(f'[kernel] gather_rope {str(dtype)[6:]} N={n} max pos 32767: '
                f'max |err| {err:.3g} (tol {tol}), untouched columns bitwise;'
                f' kernel {ms:.4f} ms, plain {plain:.4f} ms, bound '
                f'{b_ms:.4f} ms ({by})')
            if dtype is torch.bfloat16 and n == 64:    # a 4 x 16 chunk step
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=None)
        del table
    return row


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
                ms = time_ms(lambda: paged_attention(*args, **kw))
                plain = time_ms(lambda: paged_attention_plain(*args, **kw))
                lib = library_attention_ms(args[0], k, v, cpos, args[5],
                                           window)
                b_ms, by = attention_bound(args[0], k, cpos, args[5], window,
                                           dtype)
                log(f'[kernel] paged_attention {str(dtype)[6:]} B={B} T={T} '
                    f'Sc={Sc} window={window}: max |err| {err:.3g} (tol '
                    f'{tol}), empty slot zeros; kernel {ms:.4f} ms, plain '
                    f'{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms '
                    f'({by})')
                if dtype is torch.bfloat16 and T == 1 \
                        and window == cfg.window:      # the decode step
                    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=by, library_ms=lib)
    return row


def attention_bound(q, k, cpos, pos0, window, dtype):
    """Least time: the bytes of q, out, positions and the K/V rows some
    query may use, and 4*d flops per usable (query row, key) pair."""
    B, T, KV, G, d = q.shape
    pos_t = pos0[:, None].long() + torch.arange(T, device='cuda')
    valid = page_validity(cpos, pos_t, window)               # (B, T, Sc)
    rows_used = int(valid.any(dim=1).sum())
    pairs = int(valid.sum()) * KV * G
    moved = 2 * nbytes(q) + nbytes(cpos, pos0) \
        + 2 * rows_used * KV * d * k.element_size()
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


# ----------------------------------------------------------------- phase 4
def phase_engine() -> dict:
    cfg = get_config('mistral_7b')
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device='cuda', dtype=torch.bfloat16)
    table = model.build_table(params)
    torch.cuda.synchronize()
    log(f'[engine] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, '
        f'weights + table made on the card in '
        f'{time.perf_counter() - t0:.1f}s; table {tuple(table.table.shape)} '
        f'{str(table.table.dtype)[6:]}')
    eng = ServingEngine(model, params, max_slots=4, max_seq=512,
                        precomputed=table, seed=SEED, dtype=torch.bfloat16,
                        chunk_size=16, fused_gather_rope=True,
                        attn_backend='cuda', device='cuda')
    assert eng.fused_gather_rope and eng.attn_backend.name == 'cuda'
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(64, 201))).astype(np.int32),
        max_new_tokens=16) for i in range(4)]
    # warm-up request (cuBLAS handles, allocator) outside the measured run
    warm = Request(uid=100, prompt=reqs[0].prompt[:20], max_new_tokens=2)
    eng.submit(warm)
    eng.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.steps
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    report = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    for r in reqs:
        assert r.status is RequestStatus.FINISHED, (r.uid, r.status, r.error)
        assert len(r.generated) == 16, (r.uid, len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    for name, n in launches.items():
        assert n > 0, f'{name} never launched on the engine path'
    stats = eng.stats(reqs)
    steps = eng.steps - steps0
    log(f'[engine] 4 requests, prompts {[len(r.prompt) for r in reqs]}, '
        f'{stats["tokens"]} new tokens in {dt:.3f}s -> '
        f'{stats["tokens"] / dt:.1f} tok/s; {steps} steps '
        f'({dt / steps * 1e3:.2f} ms/step); mean TTFT '
        f'{stats["mean_ttft_s"]:.3f}s (p50 {report["p50_ttft_s"]:.3f}s); '
        f'mean latency {stats["mean_latency_s"]:.3f}s; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'[engine] launches {json.dumps(launches)} over {steps} steps; all '
        f'requests FINISHED with 16 tokens (finite logits)')
    profile_engine(eng, cfg, rng)
    return launches


def profile_engine(eng, cfg, rng) -> None:
    """Device time by kernel over a second batch like the measured one
    (torch.profiler recording device activity only), and the device's
    idle share of that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(uid=10 + i, prompt=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(64, 201))).astype(np.int32),
        max_new_tokens=16) for i in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total]
    busy = sum(ms for _, ms, _ in kern)
    if not busy:
        log('[profile] torch.profiler recorded no device time')
        return
    groups = {'paged_attention': 0.0, 'gather_rope': 0.0,
              'embed_gather': 0.0, 'matmul': 0.0, 'other': 0.0}
    for key, ms, _ in kern:
        name = ('paged_attention' if 'paged_attention' in key else
                'gather_rope' if 'gather_rope' in key else
                'embed_gather' if 'gather_rows' in key else
                'matmul' if ('gemm' in key.lower() or 'cutlass' in key
                             or 'nvjet' in key) else 'other')
        groups[name] += ms
    log(f'[profile] window {wall_ms:.1f} ms wall, device busy {busy:.1f} ms '
        f'(idle share {1 - busy / wall_ms:.3f}); device ms by group '
        f'{json.dumps({k: round(v, 2) for k, v in groups.items()})}')
    for key, ms, n in sorted(kern, key=lambda x: -x[1])[:8]:
        log(f'[profile]   {ms:8.2f} ms  x{n:<5d} {key[:90]}')


# ----------------------------------------------------------------- phase 5
def phase_consistency() -> None:
    cfg = get_smoke_config('mistral_7b')
    model = Model(cfg)
    params = model.init(SEED, device='cuda', dtype=torch.float32)
    table = model.build_table(params)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 23, 40, 11, 17)]
    out = {}
    for backend in ('cuda', 'reference'):
        eng = ServingEngine(model, params, max_slots=3, max_seq=96,
                            precomputed=table, seed=SEED, chunk_size=4,
                            fused_gather_rope=True, attn_backend=backend,
                            dtype=torch.float32, device='cuda')
        reqs = [Request(uid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.status is RequestStatus.FINISHED for r in reqs)
        out[backend] = [r.generated for r in reqs]
    assert out['cuda'] == out['reference'], out
    log(f'[consistency] {cfg.name} fp32: greedy tokens of the cuda and '
        f'reference backends equal ({sum(map(len, out["cuda"]))} tokens, '
        f'{len(prompts)} requests)')


def main() -> None:
    phase_device()
    phase_build()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    rows = {'embed_gather': check_embed_gather(gen),
            'gather_rope': check_gather_rope(gen),
            'paged_attention': check_paged_attention(gen)}
    launches = phase_engine()
    phase_consistency()
    replaces = {'embed_gather': 'src/repro/kernels/embed_gather.py:30',
                'gather_rope': 'src/repro/kernels/gather_rope.py:60',
                'paged_attention': 'src/repro/kernels/paged_attention.py:129'}
    kernels = [dict(name=name, route='cuda',
                    source=f'src/repro_torch/csrc/{name}.cu',
                    replaces=replaces[name], launches=launches[name], **row)
               for name, row in rows.items()]
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
