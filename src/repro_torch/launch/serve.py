"""End-to-end serving driver of the port: batched requests through the
continuous-batching engine, with the paper's precomputed first layer on by
default (port of ``repro/launch/serve.py`` for the dense engine).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-7b \
        --requests 8 --fused-gather-rope            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --new-tokens 4                 # plain versions, CPU

The architecture is its smoke config, as in the JAX driver, with random
weights from ``--seed``. ``--attn-backend auto`` takes the ``cuda`` kernel
backend on a CUDA device and the plain ``reference`` backend on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_IDS, get_smoke_config
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
    ap.add_argument('--attn-backend', default='auto',
                    choices=['auto', 'reference', 'cuda'],
                    help='"cuda": the paged_attention kernel over the dense '
                         'caches viewed as pages; "reference": plain '
                         'PyTorch, one query lane at a time; "auto": cuda on '
                         'a CUDA device, reference on the CPU')
    ap.add_argument('--deadline', type=float, default=0.0,
                    help='per-request budget in seconds (0 = none)')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(args.seed, device=args.device)
    table = None
    if not args.no_precompute and cfg.precompute_supported:
        t0 = time.time()
        table = model.build_table(params)
        print(f'precomputed table: {tuple(table.table.shape)} '
              f'({table.table.numel() * table.table.element_size() / 2**20:.1f}'
              f' MiB) built in {time.time() - t0:.2f}s')
    eng = ServingEngine(model, params, max_slots=args.slots,
                        max_seq=args.max_seq, precomputed=table,
                        seed=args.seed, chunk_size=args.chunk_size,
                        fused_gather_rope=args.fused_gather_rope,
                        attn_backend=args.attn_backend,
                        dtype=getattr(torch, cfg.dtype), device=args.device)
    if eng.chunk_size > 1:
        print(f'chunked prefill: {eng.chunk_size} tokens/dispatch'
              + (' + fused gather→RoPE' if eng.fused_gather_rope else ''))
    print(f'attention backend: {eng.attn_backend.name} on {eng.device}')
    rng = np.random.default_rng(args.seed)
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
        return
    reqs = [Request(uid=i, prompt=rng.integers(3, cfg.vocab_size,
                                               size=int(rng.integers(4, 12))),
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
    print(f'{stats["failed"]} failed, {stats["deadline_exceeded"]} '
          f'deadline-exceeded, {report["stalled"]} stalled')


if __name__ == '__main__':
    main()
