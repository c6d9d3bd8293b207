"""Does chip_smoke.py's check of the bf16 ``rmsnorm_matmul`` kernels catch a
faulty kernel, what do the 16 bits of the normalised row cost, and where
does the split-K form hand over to the wgmma form?

Builds copies of src/repro_torch/csrc/rmsnorm_matmul.cu in a temporary
directory (the checkout's source is not touched):

- mutants: the GEMM skips its second k tile (64 of d); the combine of the
  K slices drops slice 0 (the split-K form at decode sizes, and the GEMM's
  K slices where its output tiles do not fill the card); the GEMM's lo
  product reads the lo tile of the next ring stage (another k tile);
- ``hi_only``: the GEMM without its lo product, one bf16 product of 8 bits
  of the row, the precision of one ``torch.matmul`` of bf16 rows.

Runs each build through ``rmsnorm_qkv`` at chip_smoke.py's layer-0 shapes
(mistral-7b d 4096, q 4096, k/v 1024, N 1, 4, 64, 4096, 8192; glm4-9b k/v
256, N 1, 64, 4096) on seeded random rows and fan-in scaled weights, and
holds it to chip_smoke's check (``check_rms``: RMS_TOL, then the row-scaled
``RMS_ROW_TOL``). Prints for each case and build the largest error, the
share of the row limit, whether the check rejects it and whether RMS_TOL
alone would, and the time of the source's build beside ``hi_only`` at
N 4096 and 8192. Then times both forms, split-K and wgmma, on the source's
build at N 1-64 (the crossover that set ``kSplitKMaxN``), beside the single-
pass library call (F.rms_norm + torch.matmul) and the same-precision one
(``library_hilo``). Fails unless the source passes every case and every
other build fails at least one. Needs one CUDA card and nvcc.

    python3 scripts/rmsnorm_mutants.py
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke as smoke  # noqa: E402
import flash_mutants as fm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm_qkv as R  # noqa: E402

NAME = 'rmsnorm_matmul'
LO = ('        wgmma_m64n256k16(acc, wgmma_desc_sw128(alo + kk * 32, 16, '
      '1024), db, 1);\n')
# name -> None or (text of the source, its replacement), first occurrence
BUILDS = {
    'none': None,
    # the GEMM's second k tile of d contributes nothing
    'skip_k_tile': ('      for (int kk = 0; kk < gBK / 16; ++kk) {',
                    '      for (int kk = kt0 + kt == 1 ? gBK / 16 : 0; '
                    'kk < gBK / 16; ++kk) {'),
    # the combine of the K slices starts at slice 1
    'lost_slice': ('for (int s = 0; s < splits; ++s) sum +=',
                   'for (int s = 1; s < splits; ++s) sum +='),
    # the lo product reads the lo tile of the next stage of the ring
    'lo_stage': ('const uint8_t* alo = ahi + gATile;',
                 'const uint8_t* alo = smem + ((s + 1) % gStages) * gStage '
                 '+ c * 64 * 128 + gATile;'),
    # one bf16 product: hi only
    'hi_only': (LO, ''),
}
CASES = (('mistral-7b', 1024, (1, 4, 64, 4096, 8192)),
         ('glm4-9b', 256, (1, 64, 4096)))
CROSSOVER = (1, 2, 4, 8, 9, 16, 32, 64)
TIMED = (4096, 8192)


def inputs(gen, N: int, e: int, d: int = 4096, q: int = 4096):
    """x, scale, wq, wk, wv in bf16: randn rows, scale 1 + 0.1 randn,
    weights randn / sqrt(d)."""
    x = torch.randn((N, d), generator=gen, device='cuda')
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device='cuda')
    ws = [torch.randn((d, w), generator=gen, device='cuda') / d ** 0.5
          for w in (q, e, e)]
    return [t.to(torch.bfloat16) for t in (x, scale, *ws)]


def check_builds(libs, gen) -> bool:
    ok = True
    todo = [(f'{cfg} N={N}', inputs(gen, N, e), N)
            for cfg, e, counts in CASES for N in counts]
    wants = [R.rmsnorm_qkv_plain(*args) for _, args, _ in todo]
    times = {}
    for name, path in libs.items():
        fm.use(path, NAME)
        failed = []
        for (label, args, N), want in zip(todo, wants):
            got = R.rmsnorm_qkv(*args)
            torch.cuda.synchronize()
            errs = [smoke.rms_error(g, w) for g, w in zip(got, want)]
            row = dict(case=label, build=name,
                       form=R.rmsnorm_matmul_form(args[0], args[2:]),
                       max_abs_err=max(e for e, _ in errs),
                       limit_share=max(s for _, s in errs),
                       fails_smoke=not fm.passes(
                           lambda: smoke.check_rms(got, want)),
                       fails_rms_tol=not fm.passes(lambda: [
                           torch.testing.assert_close(
                               g.float(), w.float(), atol=smoke.RMS_TOL,
                               rtol=smoke.RMS_TOL)
                           for g, w in zip(got, want)]))
            if name in ('none', 'hi_only') and N in TIMED:
                row['ms'] = times[(name, label)] = smoke.time_ms(
                    lambda: R.rmsnorm_qkv(*args), 3, 3)
            smoke.log(json.dumps(row))
            if row['fails_smoke']:
                failed.append(label)
            del got
        smoke.log(json.dumps({'build': name, 'fails_smoke_at': failed}))
        ok &= bool(failed) == (name != 'none')
    for (name, label), ms in times.items():
        if name == 'hi_only':
            smoke.log(json.dumps({'case': label, 'hi_lo_ms': times[
                ('none', label)], 'hi_only_ms': ms}))
    return ok


def crossover(gen) -> None:
    """Both bf16 forms at decode sizes, on the source's build."""
    for cfg, e, _ in CASES:
        for N in CROSSOVER:
            x, scale, *ws = inputs(gen, N, e)
            cat = torch.cat(ws, dim=1)
            cat2 = torch.cat([cat, cat], dim=0)
            row = dict(case=f'{cfg} N={N}',
                       form=R.rmsnorm_matmul_form(x, ws))
            for form in ('splitk', 'wgmma'):
                row[f'{form}_ms'] = smoke.time_ms(
                    lambda: R._launch(x, scale, ws, R.EPS, form))
            row['library_ms'] = smoke.time_ms(lambda: torch.matmul(
                F.rms_norm(x, (x.shape[1],), scale, R.EPS), cat))
            row['library_hilo_ms'] = smoke.time_ms(
                lambda: smoke.library_hilo(x, scale, cat2))
            smoke.log(json.dumps(row))


def main() -> int:
    smoke.phase_device()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(smoke.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = fm.compile_all(Path(tmp), NAME, BUILDS)
        try:
            ok = check_builds(libs, gen)
            fm.use(libs['none'], NAME)
            crossover(gen)
        finally:
            build._LIBS.pop(NAME, None)
    smoke.log(json.dumps({'rmsnorm_mutants_ok': bool(ok)}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
