"""Does chip_smoke.py's check of the split ``paged_attention`` kernels (the
dense bf16 form, the MLA form and the int8 form with bf16 queries) catch a
faulty kernel, and which chunk length should they use?

Builds copies of src/repro_torch/csrc/paged_attention.cu in a temporary
directory (the checkout's source is not touched):

- mutants of the dense split kernel: a key chunk dropped (chunk 1 of every
  slot written as empty), the combine without e^(m_s - m*) (shared with
  the MLA form), and the chunk length chosen from the grid (enough chunks
  to fill 132 SMs four times, at most the source's length, so the
  boundaries move with B, KV and T);
- mutants of the MLA split kernel: a key chunk dropped, q as its bf16
  hi part only (8 bits of q, not 16), and the chunk length chosen from the
  grid;
- mutants of the int8 split kernel: a key chunk dropped, each key's
  k_scale read from its neighbour's, v_scale applied to the running sum l
  as well as to the value mix, and v_scale folded into the widened V rows
  as bf16 (the product rounded to 8 bits) instead of into p in fp32;
- the chunk lengths 64, 128 and 256 keys, in sub-tiles (commit groups)
  of 32 or 64 keys, beside the source's own (both forms; the MLA form's
  block does not fit shared memory at 256);
- a timing probe of the MLA kernel, each warp computing a quarter of the
  scores: the least time of the other MLA design (keys split over the
  warps, P exchanged through shared memory); wrong, so it must fail.

Runs each build through the ``paged_attention`` wrapper at chip_smoke.py's
bf16 shapes (mistral-7b T 1 and 16, windows 4096 and 300, on identity-table
rings; glm4-9b G 16, T 1 and 16, through a scattered table; the MLA form
at deepseek-v2-lite-16b's widths, fp32 q over bf16 latent pages, T 1 and
16; the int8 form with bf16 q at chip_smoke's int8 shapes, mistral-7b T
1 and 16, windows 4096 and 300, glm4-9b T 1 and 16) and holds it to
chip_smoke's checks: for the dense form 2e-2, then ``check_paged_bf16``
(the row-scaled limit ``FLASH_ROW_TOL`` and row t of a T 16 call bitwise
a one-token call); for the MLA form ``check_mla`` (``KERNEL_TOL`` and the
same row independence); for the int8 form ``check_quant`` (``KERNEL_TOL``
plus one bf16 step, then ``check_paged_bf16``). Prints for each case and
build the largest error, the share of the limit, whether the check rejects
it and whether the tolerance alone would; and the time of each chunk
length (CUDA-graph replays) beside ``scaled_dot_product_attention`` at the
shapes chip_smoke times. Fails unless the source and the other chunk
lengths pass every case and every mutant fails at least one (an MLA
mutant an MLA case, an int8 mutant an int8 case). Needs one CUDA card and
nvcc.

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
    mla_split_form, paged_attention, paged_attention_plain,
    paged_attention_quant, quant_split_form)
from repro_torch.models.attn_backend import KERNEL_TOL  # noqa: E402
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
# the MLA kernel's score products of one 16-key group, and those of one
# 8-key n-tile a warp (the timing probe below)
MLA_S_PRODUCTS = '''        unsigned bk[4];
        ldsm_x4(bk, tk + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * L + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(sc[2 * j2], ah, bk[0], bk[1]);
        mma(sc[2 * j2 + 1], ah, bk[2], bk[3]);
        mma(sl[2 * j2], al, bk[0], bk[1]);
        mma(sl[2 * j2 + 1], al, bk[2], bk[3]);'''
MLA_S_QUARTER = '''        if (j2 != warp >> 1) continue;
        unsigned bk[4];
        ldsm_x4(bk, tk + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * L + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        if (warp & 1) {
          mma(sc[2 * j2 + 1], ah, bk[2], bk[3]);
          mma(sl[2 * j2 + 1], al, bk[2], bk[3]);
        } else {
          mma(sc[2 * j2], ah, bk[0], bk[1]);
          mma(sl[2 * j2], al, bk[0], bk[1]);
        }'''
# the same grid-chosen length in the MLA launch (16-row tiles, one kv head)
MLA_GRID_CHUNK = '''  const int chunk = [&] {
    const int blocks = B * ((R + kRows - 1) / kRows);
    const int want = (4 * 132 + blocks - 1) / blocks;
    const int c = ((S + want - 1) / want + 15) / 16 * 16;
    return c < 16 ? 16 : (c > kChunk ? kChunk : c);
  }();'''


def split_lengths(chunk: int, sub: int):
    """The edit that sets the chunk and sub-tile lengths."""
    return SPLIT.group(0), (f'constexpr int kChunk = {chunk};{SPLIT.group(2)}'
                            f'\nconstexpr int kSub = {sub};')


SOURCE = (build.CSRC / f'{NAME}.cu').read_text()


def edits(*pairs):
    """Several edits as one (anchor, replacement) for ``compile_all``: the
    whole source and the source with each pair's first occurrence
    replaced."""
    text = SOURCE
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f'{old!r} is no longer in {NAME}.cu')
        text = text.replace(old, new, 1)
    return SOURCE, text


# the int8 form: each key's v_scale multiplies its widened V row, rounded
# to bf16, after the widening
WIDEN = """      widen_sub<D>(sStK, sStV, sK, sV, s);
      __syncthreads();  // and widened to bf16
"""
FOLD_VS = WIDEN + """      for (int e = tid; e < kSub * D; e += kThreads) {
        const int jj = s * kSub + e / D;
        bf16* x = sV + jj * L::kLd + e % D;
        *x = __float2bfloat16_rn(__bfloat162float(*x) * sVs[jj]);
      }
      __syncthreads();
"""
P_VS = '        sc[j][e] = Q ? p * tvs[8 * j + 2 * tq + (e & 1)] : p;'

LENGTHS = {f'chunk{c}_sub{u}': c
           for c, u in ((64, 32), (64, 64), (128, 32), (128, 64), (256, 64))}
SWEEP = {name: split_lengths(c, int(name.split('sub')[1]))
         for name, c in LENGTHS.items()
         if name != f'chunk{SPLIT.group(1)}_sub{SPLIT.group(3)}'}


def fits(build_name: str, label: str) -> bool:
    """Whether the case's kernel fits one block's shared memory in this
    build: an MLA block holds 32 q rows (hi, lo) and the chunk's key rows of
    576 + 8 bf16, so chunks of 256 keys (336 KB) do not fit 227 KB."""
    if not label.startswith('mla') or build_name not in LENGTHS:
        return True
    return (32 + LENGTHS[build_name]) * 584 * 2 + 8 * LENGTHS[build_name] \
        <= 232448


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
    # MLA: chunk 1 of every slot is treated as holding no key
    'mla_drop_chunk': ('  if (!__syncthreads_or(live)) {  // no usable key '
                       'for the tile', '  if (z == 1) live = false;\n'
                       '  if (!__syncthreads_or(live)) {  // no usable key '
                       'for the tile'),
    # MLA: q as bf16 (its hi part) only, one product a k-step: 8 bits of q
    'mla_hi_only': ('const float rest = x - __bfloat162float(h);',
                    'const float rest = 0.f;'),
    # MLA: the chunk length chosen from the grid (moves with T)
    'mla_chunk_from_grid': ('  const int chunk = split::chunk_len(B, 1, R, S);',
                            MLA_GRID_CHUNK),
    # int8: chunk 1 of every slot is treated as holding no key
    'quant_drop_chunk': ('  if (!__syncthreads_or(live)) {',
                         '  if (Q && blockIdx.z == 1) live = false;\n'
                         '  if (!__syncthreads_or(live)) {'),
    # int8: each key's score scaled by its neighbour's k_scale
    'quant_ks_neighbour': ('x *= tks[key];', 'x *= tks[key ^ 1];'),
    # int8: the running sum l takes p * v_scale, not p
    'quant_vs_in_l': ('        sum[e >> 1] += p;\n        // l sums p',
                      '        sum[e >> 1] += Q ? p * tvs[8 * j + 2 * tq + '
                      '(e & 1)] : p;\n        // l sums p'),
    # int8: v_scale folded into V as bf16 (int8 x bf16 rounded to 8 bits)
    # instead of into p in fp32
    'quant_vs_folded_bf16': edits((WIDEN, FOLD_VS),
                                  (P_VS, '        sc[j][e] = p;')),
    # MLA, a timing probe: each warp computes only a quarter of S (one of
    # the four 8-key n-tiles of a sub-tile). Wrong, so it must fail; its
    # time bounds from below the other design, in which the warps split
    # the keys and exchange P through shared memory (that design adds two
    # barriers and the exchange a sub-tile).
    'mla_s_quarter': (MLA_S_PRODUCTS, MLA_S_QUARTER),
}
TIMED_PROBES = ('mla_s_quarter',)
RIGHT = ('none', *SWEEP)
TIMED = ('mistral T=1 window=4096', 'mistral T=16 window=4096',
         'glm4 T=1', 'glm4 T=16', 'mla T=1', 'mla T=16',
         'int8 mistral Sc=512 window=4096 T=1',
         'int8 mistral Sc=512 window=4096 T=16',
         'int8 glm4 scattered table over NP=1537 T=1',
         'int8 glm4 scattered table over NP=1537 T=16')


def launch(label, args, kw):
    """The case's wrapper: paged_attention_quant for the int8 cases, else
    paged_attention."""
    if label.startswith('int8'):
        return paged_attention_quant(*args, **kw)
    return paged_attention(*args, **kw)


def plain(label, args, kw):
    """The plain version of the case's wrapper."""
    if label.startswith('int8'):
        return smoke.quant_plain(args, kw)
    return paged_attention_plain(*args, **kw)


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
    k, v, cpos, table = smoke.scattered_pool(gen, bf16)
    view = paged_view({'k': k, 'v': v, 'pos': cpos}, table, smoke.GLM_SEQ)
    for T in (1, 16):
        q, pos0 = smoke.scattered_queries(gen, bf16, T)
        lib = smoke.library_attention_ms(q, view['k'], view['v'],
                                         view['pos'], pos0, 0)
        out.append((f'glm4 T={T}', (q, k, v, cpos, table, pos0),
                    dict(scale=q.shape[-1] ** -0.5, window=0), lib))
    ds = get_config(smoke.DS)
    H, r, dr = ds.num_heads, ds.mla.kv_lora_rank, ds.mla.qk_rope_dim
    lengths = [300, 271, 0, 365]
    ckv, kpe, cpos, table = smoke.mla_pool(
        gen, torch.bfloat16, smoke.glm_pool_pages(), smoke.GLM_PS, r, dr,
        lengths, smoke.GLM_SEQ // smoke.GLM_PS)
    view = paged_view({'ckv': ckv, 'kpe': kpe, 'pos': cpos}, table,
                      smoke.GLM_SEQ)
    scale = (ds.mla.qk_nope_dim + dr) ** -0.5
    for T in (1, 16):
        pos0 = torch.tensor([max(n - T, 0) for n in lengths],
                            dtype=torch.int32, device='cuda')
        q = torch.randn((len(lengths), T, 1, H, r + dr), generator=gen,
                        device='cuda')
        assert mla_split_form(q, ckv, kpe)
        out.append((f'mla T={T}', (q, ckv[:, :, None], None, cpos, table,
                                   pos0),
                    dict(scale=scale, k2_pages=kpe[:, :, None], mla_split=r),
                    smoke.library_mla_ms(q, view, pos0, r, scale)))
    for label, args, kw, _ in smoke.quant_cases(gen, (torch.bfloat16,)):
        assert quant_split_form(args[0], args[1])
        out.append((f'int8 {label}', args, kw, None))
    return out


def check(label, got, want, args, kw) -> None:
    """chip_smoke.py's checks of the case's form, in its order: the dense
    bf16 form's, the MLA form's or the int8 form's."""
    if label.startswith('mla'):
        smoke.check_mla(got, want, args, kw)
        return
    if label.startswith('int8'):
        smoke.check_quant(label, got, want, args, kw)
        return
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    smoke.check_paged_bf16(label, got, want, args, kw)


def tol_alone(label, got, want) -> None:
    """The case's tolerance alone: 2e-2 (dense bf16), KERNEL_TOL (MLA) or
    KERNEL_TOL plus one bf16 step (int8)."""
    if label.startswith('int8'):
        _, share = error(label, got, want)
        assert share <= 1
        return
    tol = KERNEL_TOL if label.startswith('mla') else dict(atol=TOL, rtol=TOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def error(label, got, want) -> tuple:
    """(largest |error|, its share of the case's limit): the row-scaled
    limit (dense bf16), KERNEL_TOL (MLA) or KERNEL_TOL plus one bf16 step
    (int8, bf16 q)."""
    if not label.startswith(('mla', 'int8')):
        return smoke.flash_error(got, want)
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = KERNEL_TOL['atol'] + KERNEL_TOL['rtol'] * want.abs()
    if label.startswith('int8'):
        limit = limit + want.abs() * 2.0 ** -7
    return diff.max().item(), (diff / limit).max().item()


def main() -> int:
    smoke.phase_device()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(smoke.SEED)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = fm.compile_all(Path(tmp), NAME, BUILDS)
        try:
            todo = cases(gen)
            wants = [plain(label, a, kw) for label, a, kw, _ in todo]
            for name, path in libs.items():
                fm.use(path, NAME)
                failed = []
                for (label, args, kw, lib), want in zip(todo, wants):
                    if not fits(name, label):
                        smoke.log(json.dumps(dict(
                            case=label, build=name,
                            skipped='exceeds shared memory')))
                        continue
                    got = launch(label, args, kw)
                    torch.cuda.synchronize()
                    err, share = error(label, got, want)
                    row = dict(case=label, build=name, max_abs_err=err,
                               limit_share=share,
                               fails_smoke=not fm.passes(lambda: check(
                                   label, got, want, args, kw)),
                               fails_tol_alone=not fm.passes(
                                   lambda: tol_alone(label, got, want)))
                    if (name in RIGHT or name in TIMED_PROBES) \
                            and label in TIMED:
                        row.update(ms=smoke.time_ms(
                            lambda: launch(label, args, kw)),
                            sdpa_ms=lib)
                    smoke.log(json.dumps(row))
                    if row['fails_smoke']:
                        failed.append(label)
                # an MLA (int8) mutant must fail an MLA (int8) case
                own = 'mla' if name.startswith('mla') else \
                    'int8' if name.startswith('quant') else ''
                caught = any(f.startswith(own) for f in failed)
                smoke.log(json.dumps({'build': name,
                                      'fails_smoke_at': failed}))
                ok &= caught == (name not in RIGHT)
        finally:
            build._LIBS.pop(NAME, None)
    smoke.log(json.dumps({'paged_mutants_ok': bool(ok)}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
