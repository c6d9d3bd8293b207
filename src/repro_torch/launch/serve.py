"""End-to-end serving driver of the port: batched requests through the
continuous-batching engine, with the paper's precomputed first layer on by
default (port of ``repro/launch/serve.py`` for the dense engine and the
paged KV pool with the prefix cache).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-7b \
        --requests 8 --fused-gather-rope            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --new-tokens 4                 # plain versions, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --prefix-cache --shared-prefix 32 --fused-gather-rope   # paged
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --prefix-cache --fused-gather-rope  # MLA
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch glm4-9b --prefix-cache --mesh 2x2    # a 2x2 mesh of one CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --prefix-cache --page-size 8 --shared-prefix 16   # ring pages
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch glm4-9b --prefix-cache --metrics-out m.prom \
        --trace-out trace.json                      # telemetry exports
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --prefix-cache --max-slots 256 --requests 3  # a wide engine
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --prefix-cache --async-loop                 # the async host loop
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch gemma3-1b --prefix-cache --page-size 8 \
        --shared-prefix 16 --fused-gather-rope      # gemma3: 5:1 rings
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma3-27b --prefix-cache --fused-gather-rope  # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch internvl2-1b --prefix-cache --fused-gather-rope  # text only
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mixtral-8x7b-parallel --prefix-cache \
        --fused-gather-rope      # or mixtral-8x7b: MoE over ring pages
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama3-405b --prefix-cache --fused-gather-rope  # linear pages
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --prefix-cache --shared-prefix 16   # recurrent: snapshots, no pages
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --chunk-size 4          # attention beside mamba heads, meta tokens

The architecture is its smoke config, as in the JAX driver, with random
weights from ``--seed``; an audio config (whisper) exits with the JAX
CLI's message, as there; ``--prefix-cache`` with hymba-1.5b (meta
tokens) raises the engine's ``ValueError``, as JAX's; ``--fused-gather-rope``
falls back to the plain gather where layer 0 is no attention layer
(xlstm-125m, hymba-1.5b), as JAX's. ``--attn-backend auto`` takes the ``cuda`` kernel
backend on a CUDA device and the plain ``reference`` backend on the CPU.
``--metrics-out`` writes the telemetry registry (the five step phases by
backend and step kind, request latency and TTFT, the pool's gauges):
Prometheus text for a ``.prom`` / ``.txt`` path, JSON otherwise.
``--trace-out`` writes the request spans as Chrome trace-event JSON (one
track per request; open it in ``chrome://tracing`` or Perfetto).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_IDS, get_smoke_config
from repro_torch.launch.mesh import make_serving_mesh, parse_mesh_spec
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--arch', default='mistral-7b',
                    help=f'one of {ALL_IDS} (smoke config)')
    ap.add_argument('--device', default='cuda',
                    help='torch device to serve on ("cuda" or "cpu")')
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--max-slots', type=int, default=0,
                    help='override the engine slot count (0 = --slots). '
                         'Large values are cheap to hold: dispatches are '
                         'sliced to the smallest power-of-two bucket '
                         'covering the active slots, so a 256-slot engine '
                         'serving 3 requests runs an 8-wide step (one CUDA '
                         'graph per step shape on the card)')
    ap.add_argument('--new-tokens', type=int, default=24)
    ap.add_argument('--max-seq', type=int, default=256)
    ap.add_argument('--temperature', type=float, default=0.0)
    ap.add_argument('--no-precompute', action='store_true')
    ap.add_argument('--chunk-size', type=int, default=16,
                    help='prompt tokens per prefill dispatch (1 = token-by-'
                         'token)')
    ap.add_argument('--fused-gather-rope', action='store_true',
                    help='fold layer-0 RoPE into the precomputed-row gather '
                         '(needs precompute and chunking)')
    ap.add_argument('--score', action='store_true',
                    help='score each prompt (mean token logprob) instead of '
                         'generating')
    ap.add_argument('--prefix-cache', action='store_true',
                    help='paged KV pool + shared-prefix radix cache: '
                         'requests sharing a cached prompt prefix attach '
                         'its pages and skip that prefill work; windowed '
                         "layers (mistral-7b's) keep private ring pages and "
                         'resume from snapshots')
    ap.add_argument('--page-size', type=int, default=16,
                    help='tokens per KV page (prefix-cache mode; must '
                         'divide --max-seq)')
    ap.add_argument('--num-pages', type=int, default=0,
                    help='KV pool size in pages (0 = auto: slots + cache '
                         'headroom)')
    ap.add_argument('--shared-prefix', type=int, default=0,
                    help='prepend a common system prompt of this many '
                         'tokens to every request (shows the prefix-cache '
                         'hit rate)')
    ap.add_argument('--attn-backend', default='auto',
                    choices=['auto', 'reference', 'cuda'],
                    help='"cuda": the paged_attention kernel over the pool '
                         'pages (or the dense caches viewed as pages) and '
                         'the page-maintenance kernels; "reference": plain '
                         'PyTorch, one query lane at a time; "auto": cuda on '
                         'a CUDA device, reference on the CPU')
    ap.add_argument('--mesh', default='',
                    help='serving device mesh "PxH" (pool x heads), e.g. '
                         '"2x2" (prefix-cache mode): KV pool storage rests '
                         'in blocks over P x H devices and the cuda attend '
                         'runs over H kv-head shards; tokens stay bitwise '
                         'the one-device engine\'s. Empty / "1x1" = no mesh. '
                         'With --device cpu the CPU is repeated P*H times; '
                         'on CUDA it takes the first P*H GPUs and raises '
                         'when there are fewer. Impossible shapes raise '
                         'ValueError')
    ap.add_argument('--deadline', type=float, default=0.0,
                    help='per-request budget in seconds (0 = none)')
    ap.add_argument('--telemetry', action='store_true',
                    help='enable the metrics registry + per-request span '
                         'tracer (host-side; tokens stay bit-identical). '
                         'Implied by --metrics-out / --trace-out')
    ap.add_argument('--metrics-out', default='',
                    help='write the metrics registry to this file: '
                         'Prometheus exposition text for .prom/.txt, '
                         'structured JSON otherwise')
    ap.add_argument('--trace-out', default='',
                    help='write request spans as Chrome trace-event JSON '
                         '(chrome://tracing / Perfetto)')
    ap.add_argument('--async-loop', action='store_true',
                    help='async double-buffered host loop: schedule step '
                         'N+1 while step N runs (one-step sampling lag; '
                         'greedy tokens identical; not with --mesh)')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    want_telemetry = bool(args.telemetry or args.metrics_out
                          or args.trace_out)

    mesh = None
    shape = parse_mesh_spec(args.mesh)
    if shape is not None:
        on_cpu = torch.device(args.device).type == 'cpu'
        mesh = make_serving_mesh(shape, devices=[torch.device('cpu')]
                                 * (shape[0] * shape[1]) if on_cpu else None)
    cfg = get_smoke_config(args.arch)
    if cfg.arch_class in ('audio',):
        raise SystemExit('use examples/whisper_transcribe.py for audio')
    model = Model(cfg)
    params = model.init(args.seed, device=args.device)
    table = None
    if not args.no_precompute and cfg.precompute_supported:
        t0 = time.time()
        table = model.build_table(params)
        print(f'precomputed table: {tuple(table.table.shape)} '
              f'({table.table.numel() * table.table.element_size() / 2**20:.1f}'
              f' MiB) built in {time.time() - t0:.2f}s')
    eng = ServingEngine(model, params,
                        max_slots=args.max_slots or args.slots,
                        max_seq=args.max_seq, precomputed=table,
                        seed=args.seed, chunk_size=args.chunk_size,
                        fused_gather_rope=args.fused_gather_rope,
                        prefix_cache=args.prefix_cache,
                        page_size=args.page_size,
                        num_pages=args.num_pages or None,
                        attn_backend=args.attn_backend, mesh=mesh,
                        telemetry=want_telemetry,
                        async_loop=args.async_loop,
                        dtype=getattr(torch, cfg.dtype), device=args.device)
    if eng.mesh is not None:
        p, h = eng.mesh.shape
        devs = [str(d) for row in eng.mesh.devices for d in row]
        print(f'serving mesh: {p}x{h} (pool x heads) over {len(devs)} '
              f'devices ({", ".join(devs)})')
    if eng.async_loop:
        print('async double-buffered host loop (one-step sampling lag)')
    if eng.chunk_size > 1:
        print(f'chunked prefill: {eng.chunk_size} tokens/dispatch'
              + (' + fused gather→RoPE' if eng.fused_gather_rope else ''))
    print(f'attention backend: {eng.attn_backend.name} on {eng.device}')
    if eng.paged:
        print(f'paged KV: {eng.num_pages} pages x {eng.page_size} tokens')
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(3, cfg.vocab_size, size=args.shared_prefix)
    if args.score:
        prompts = [rng.integers(3, cfg.vocab_size,
                                size=int(rng.integers(4, 12)))
                   for _ in range(args.requests)]
        t0 = time.time()
        all_logits = eng.score(prompts)
        dt = time.time() - t0
        for i, (p, lg) in enumerate(zip(prompts, all_logits)):
            m = lg.max(-1, keepdims=True)
            logp = lg - m - np.log(np.exp(lg - m).sum(-1, keepdims=True))
            mean_lp = float(np.mean([logp[t - 1, p[t]]
                                     for t in range(1, len(p))]))
            print(f'prompt {i}: len={len(p)} logits={lg.shape} '
                  f'mean token logprob={mean_lp:.3f}')
        print(f'scored {len(prompts)} prompts '
              f'({sum(len(p) for p in prompts)} tokens) in {dt:.2f}s')
        _write_exports(eng, args)
        return
    reqs = [Request(uid=i, prompt=np.concatenate(
        [shared, rng.integers(3, cfg.vocab_size,
                              size=int(rng.integers(4, 12)))]),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature,
                    deadline_s=args.deadline or None)
            for i in range(args.requests)]
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    report = eng.run()
    dt = time.time() - t0
    stats = eng.stats(reqs)

    def fmt(key: str) -> str:
        return f'{stats[key]:.3f}s' if key in stats else 'n/a'

    print(f'{stats["completed"]} requests, {stats["tokens"]} new tokens in '
          f'{dt:.2f}s -> {stats["tokens"] / dt:.1f} tok/s '
          f'(mode={"precompute" if table is not None else "baseline"})')
    print(f'mean latency {fmt("mean_latency_s")} '
          f'(p50 {fmt("p50_latency_s")} / p99 {fmt("p99_latency_s")}), '
          f'mean TTFT {fmt("mean_ttft_s")} '
          f'(p50 {fmt("p50_ttft_s")} / p99 {fmt("p99_ttft_s")}), '
          f'engine steps {stats["engine_steps"]}')
    print(f'fault tolerance: {stats["preemptions"]} preemptions, '
          f'{stats["failed"]} failed, {stats["cancelled"]} cancelled, '
          f'{stats["deadline_exceeded"]} deadline-exceeded, '
          f'{report["stalled"]} stalled')
    print(f'{eng.max_slots} slots; step programs (path, slot bucket, T, '
          f'logits): {sorted(eng.programs)}'
          + (' as CUDA graphs' if eng._graphs else ''))
    if eng.paged:
        print(f'prefix cache: {stats["prefix_hits"]} hits / '
              f'{stats["prefix_misses"]} misses '
              f'(rate {stats["prefix_hit_rate"]:.2f}), '
              f'{stats["prefix_hit_tokens"]} hit tokens, '
              f'{stats["cow_copies"]} copy-on-write, '
              f'{stats["pages_in_use"]} pages in use, '
              f'{stats["evictions"]} evictions; TTFT on hit '
              f'{fmt("mean_ttft_on_hit_s")}')
    _write_exports(eng, args)


def _write_exports(eng: ServingEngine, args) -> None:
    """Dump the telemetry registry / trace where --metrics-out / --trace-out
    point. Prometheus text for .prom/.txt metric paths, JSON otherwise."""
    if args.metrics_out:
        if args.metrics_out.endswith(('.prom', '.txt')):
            eng.telemetry.write_prometheus(args.metrics_out)
        else:
            eng.telemetry.write_json(args.metrics_out)
        print(f'metrics -> {args.metrics_out}')
    if args.trace_out:
        eng.telemetry.write_chrome_trace(args.trace_out)
        print(f'trace -> {args.trace_out}')


if __name__ == '__main__':
    main()
