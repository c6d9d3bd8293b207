"""Does chip_smoke.py's check of the split bf16 ``paged_attention`` kernel
catch a faulty kernel, and which chunk length should it use?

Builds copies of src/repro_torch/csrc/paged_attention.cu in a temporary
directory (the checkout's source is not touched):

- mutants: a key chunk dropped (chunk 1 of every slot written as empty),
  the combine without e^(m_s - m*), and the chunk length chosen from the
  grid (enough chunks to fill 132 SMs four times, at most the source's
  length, so the boundaries move with B, KV and T);
- the chunk lengths 64, 128 and 256 keys, in sub-tiles (commit groups)
  of 32 or 64 keys, beside the source's own.

Runs each build through the ``paged_attention`` wrapper at chip_smoke.py's
bf16 shapes (mistral-7b T 1 and 16, windows 4096 and 300, on identity-table
rings; glm4-9b G 16, T 1 and 16, through a scattered table) and holds it to
chip_smoke's checks: 2e-2, then ``check_paged_bf16`` (the row-scaled limit
``FLASH_ROW_TOL`` and row t of a T 16 call bitwise a one-token call).
Prints for each case and build the largest error, the share of the limit,
whether the check rejects it and whether 2e-2 alone would; and the time of
each chunk length (CUDA-graph replays) beside ``scaled_dot_product_attention``
at the four shapes chip_smoke times. Fails unless the source and the other
chunk lengths pass every case and every mutant fails at least one. Needs one
CUDA card and nvcc.

    python3 scripts/paged_mutants.py
"""
from __future__ import annotations

import json
import re
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke as smoke  # noqa: E402
import flash_mutants as fm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_plain)
from repro_torch.models.attention import paged_view  # noqa: E402

NAME = 'paged_attention'
TOL = 2e-2                                    # chip_smoke's bf16 tolerance
SPLIT = re.search(r'constexpr int kChunk = (\d+);(.*)\nconstexpr int kSub = '
                  r'(\d+);', (build.CSRC / f'{NAME}.cu').read_text())
GRID_CHUNK = '''int chunk_len(int B, int KV, int R, int S) {
  const int blocks = B * KV * ((R + kRows - 1) / kRows);
  const int want = (4 * 132 + blocks - 1) / blocks;
  const int c = ((S + want - 1) / want + 15) / 16 * 16;
  return c < 16 ? 16 : (c > kChunk ? kChunk : c);
}'''


def split_lengths(chunk: int, sub: int):
    """The edit that sets the chunk and sub-tile lengths."""
    return SPLIT.group(0), (f'constexpr int kChunk = {chunk};{SPLIT.group(2)}'
                            f'\nconstexpr int kSub = {sub};')


SWEEP = {f'chunk{c}_sub{u}': split_lengths(c, u)
         for c, u in ((64, 32), (64, 64), (128, 32), (128, 64), (256, 64))
         if (str(c), str(u)) != (SPLIT.group(1), SPLIT.group(3))}
# name -> None or (text of the source, its replacement), first occurrence
BUILDS = {
    'none': None,
    **SWEEP,
    # chunk 1 of every slot is treated as holding no key
    'drop_chunk': ('  if (!__syncthreads_or(live)) {',
                   '  if (blockIdx.z == 1) live = false;\n'
                   '  if (!__syncthreads_or(live)) {'),
    # the partials are summed without their weights e^(m_s - m*)
    'combine_no_rescale': ('const float w = expf(x.x - mstar);',
                           'const float w = 1.f;'),
    # an occupancy-chosen split: right within 2e-2, but a row's chunks
    # depend on T, so a 16-token call is not 16 one-token calls bitwise
    'chunk_from_grid': ('int chunk_len(int B, int KV, int R, int S) '
                        '{ return kChunk; }', GRID_CHUNK),
}
RIGHT = ('none', *SWEEP)
TIMED = ('mistral T=1 window=4096', 'mistral T=16 window=4096',
         'glm4 T=1', 'glm4 T=16')


def cases(gen) -> list:
    """(label, args, kwargs, sdpa ms or None) at chip_smoke's bf16 shapes."""
    bf16 = torch.bfloat16
    cfg = get_config('mistral_7b')
    KV, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    out = []
    for T in (1, 16):
        for window in (cfg.window, 300):
            args, (k, v, cpos) = smoke.ring_case(gen, bf16, 4, T, KV, G, d,
                                                 512, [700, 300, 0, 549])
            label = f'mistral T={T} window={window}'
            lib = smoke.library_attention_ms(args[0], k, v, cpos, args[5],
                                             window) \
                if label in TIMED else None
            out.append((label, args, dict(scale=d ** -0.5, window=window),
                        lib))
    k, v, cpos, table = smoke.glm4_pool(gen, bf16)
    view = paged_view({'k': k, 'v': v, 'pos': cpos}, table, smoke.GLM_SEQ)
    for T in (1, 16):
        q, pos0 = smoke.glm4_queries(gen, bf16, T)
        lib = smoke.library_attention_ms(q, view['k'], view['v'],
                                         view['pos'], pos0, 0)
        out.append((f'glm4 T={T}', (q, k, v, cpos, table, pos0),
                    dict(scale=q.shape[-1] ** -0.5, window=0), lib))
    return out


def check(label, got, want, args, kw) -> None:
    """chip_smoke.py's bf16 checks of the dense form, in its order."""
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    smoke.check_paged_bf16(label, got, want, args, kw)


def main() -> int:
    smoke.phase_device()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(smoke.SEED)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = fm.compile_all(Path(tmp), NAME, BUILDS)
        try:
            todo = cases(gen)
            wants = [paged_attention_plain(*a, **kw) for _, a, kw, _ in todo]
            for name, path in libs.items():
                fm.use(path, NAME)
                failed = []
                for (label, args, kw, lib), want in zip(todo, wants):
                    got = paged_attention(*args, **kw)
                    torch.cuda.synchronize()
                    err, share = smoke.flash_error(got, want)
                    row = dict(case=label, build=name, max_abs_err=err,
                               limit_share=share,
                               fails_smoke=not fm.passes(lambda: check(
                                   label, got, want, args, kw)),
                               fails_2e_2=not fm.passes(
                                   lambda: torch.testing.assert_close(
                                       got.float(), want.float(), atol=TOL,
                                       rtol=TOL)))
                    if name in RIGHT and label in TIMED:
                        row.update(ms=smoke.time_ms(
                            lambda: paged_attention(*args, **kw)),
                            sdpa_ms=lib)
                    smoke.log(json.dumps(row))
                    if row['fails_smoke']:
                        failed.append(label)
                caught = bool(failed)
                smoke.log(json.dumps({'build': name,
                                      'fails_smoke_at': failed}))
                ok &= caught == (name not in RIGHT)
        finally:
            build._LIBS.pop(NAME, None)
    smoke.log(json.dumps({'paged_mutants_ok': bool(ok)}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
