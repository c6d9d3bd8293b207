"""Greedy tokens of chip_smoke.py's engine runs in this checkout against
another checkout's (for example the parent commit, unpacked with ``git
archive``), and ``gather_rope`` rows on seeded inputs, bitwise. Full width,
random bf16 weights from chip_smoke's seed:

- ``deepseek`` (the default): deepseek-v2-lite-16b, two waves of 4
  requests through the paged pool, every attend through
  ``paged_attention_mla``;
- ``glm4``: glm4-9b the same way in bf16, then over the int8 pool
  (``paged_attention``, then ``paged_attention_quant``; the int8 pool's
  writes quantize inside ``fused_page_write`` where the checkout does so);
- ``mistral``: mistral-7b on dense ring caches, phase 4's three runs (bf16
  with the table, without it, int8 KV caches).

Each checkout runs in a subprocess of its own, with its own kernels, and
also hashes ``gather_rope``'s output at the mistral-7b, glm4-9b and
deepseek-v2-lite-16b row layouts (bf16 and fp32 tables of 4096 rows, N 1,
4, 64 and 512, ids that include wrapped and out-of-range ones, positions
below 32768). Prints for each run whether the requests' tokens are equal
and, where they are not, the first request and position that differ, then
whether the rows are; exits 1 if anything differs. Needs one CUDA card.

    python3 scripts/deepseek_tokens_ab.py OTHER_CHECKOUT \
        [deepseek|glm4|mistral]
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROPE_ROWS = 4096


def mistral_runs(smoke) -> None:
    """Phase 4's three engine runs, as ``phase_mistral`` starts them."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config('mistral_7b')
    model = Model(cfg)
    params = model.init(smoke.SEED, device='cuda', dtype=torch.bfloat16)
    table = model.build_table(params)
    rng = np.random.default_rng(smoke.SEED)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(rng.integers(
        64, 201))).astype(np.int32) for _ in range(4)]
    for tab, kv_quant in ((table, False), (None, False), (table, True)):
        smoke.serve_dense(model, params, tab, prompts, rng, kv_quant)
        smoke.free()


def rope_digests(smoke) -> dict:
    """sha256 of ``gather_rope``'s rows at each row layout, dtype and N."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_rope import gather_rope
    gen = torch.Generator(device='cuda').manual_seed(smoke.SEED)
    out = {}
    for name in ('mistral_7b', 'glm4_9b', smoke.DS):
        cfg = get_config(name)
        kw = dict(segs=smoke.rope_segments(cfg), theta=cfg.rope_theta)
        for dtype in (torch.bfloat16, torch.float32):
            table = torch.randn((ROPE_ROWS, cfg.precompute_row_width),
                                generator=gen, device='cuda').to(dtype)
            for n in (1, 4, 64, 512):
                ids = torch.randint(-ROPE_ROWS - 8, ROPE_ROWS + 8, (n,),
                                    generator=gen, device='cuda',
                                    dtype=torch.int32)
                pos = torch.randint(0, 32768, (n,), generator=gen,
                                    device='cuda', dtype=torch.int32)
                rows = gather_rope(table, ids, pos, **kw)
                out[f'{cfg.name} {str(dtype)[6:]} N={n}'] = hashlib.sha256(
                    rows.cpu().view(torch.uint8).numpy().tobytes()
                ).hexdigest()
            del table
    return out


def dump(root: Path, arch: str) -> None:
    """In the subprocess: run ``root``'s engine runs and print their
    tokens and the gather_rope digests."""
    sys.path[:0] = [str(root), str(root / 'src')]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    smoke.phase_device()
    tokens = []
    serve = smoke.serve_dense if arch == 'mistral' else smoke.serve_waves

    def keep(*args, **kwargs):
        out = serve(*args, **kwargs)
        if not kwargs.get('eager'):     # an eager twin repeats a run
            tokens.append(out[1])
        return out
    if arch == 'mistral':
        smoke.serve_dense = keep
        mistral_runs(smoke)
    elif arch == 'glm4':
        smoke.serve_waves = keep
        smoke.phase_paged(get_config('glm4_9b'), 'glm4', 'paged_attention',
                          int8=True)
    else:
        smoke.serve_waves = keep
        smoke.phase_paged(get_config(smoke.DS), 'deepseek',
                          'paged_attention_mla')
    smoke.free()
    print(json.dumps({'tokens': tokens, 'rope': rope_digests(smoke)}),
          flush=True)


def run(root: Path, arch: str) -> dict:
    out = subprocess.run([sys.executable, __file__, '--dump', str(root),
                          arch], capture_output=True, text=True, cwd=root)
    if out.returncode:
        raise SystemExit(f'{root}: exit {out.returncode}\n{out.stderr}')
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        if f'[{arch}' in line or '[engine' in line or '[device]' in line:
            print(f'{root.name}: {line}', flush=True)
    return json.loads(lines[-1])


def main() -> int:
    if sys.argv[1] == '--dump':
        dump(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    other = Path(sys.argv[1]).resolve()
    arch = sys.argv[2] if len(sys.argv) > 2 else 'deepseek'
    mine, theirs = run(ROOT, arch), run(other, arch)
    for k, (a, b) in enumerate(zip(mine['tokens'], theirs['tokens'])):
        diff = [(i, next(j for j, (u, w) in enumerate(zip(x, y)) if u != w))
                for i, (x, y) in enumerate(zip(a, b)) if x != y]
        print(json.dumps({'arch': arch, 'run': k, 'requests': len(a),
                          'tokens': sum(map(len, a)), 'equal': a == b,
                          'first_differences': diff}), flush=True)
    rope_diff = sorted(key for key in mine['rope']
                       if mine['rope'][key] != theirs['rope'].get(key))
    print(json.dumps({'arch': arch, 'gather_rope_cases': len(mine['rope']),
                      'bitwise_equal': not rope_diff,
                      'differ': rope_diff}), flush=True)
    same = mine['tokens'] == theirs['tokens'] and not rope_diff
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
