"""Does chip_smoke.py's bf16 check of the flash_attention kernel catch a
faulty kernel?

Builds deliberately broken copies of src/repro_torch/csrc/flash_attention.cu
in a temporary directory (the checkout's source is not touched): a key tile
skipped after its copies, the register accumulator not rescaled when the
running max rises, no correction at all. Runs each
through the ``flash_attention`` wrapper at chip_smoke.py's ``FLASH_CASES``
in bf16, and prints for each the largest error against the plain version,
the share of chip_smoke's row-scaled limit (``FLASH_ROW_TOL``) it uses,
whether chip_smoke's check (``check_flash``) rejects it, and whether
tests/test_kernels.py's atol = rtol = 3e-2 alone would. Fails unless the
unbroken source passes chip_smoke's check and every mutant fails it. Needs
one CUDA card and nvcc.

    python3 scripts/flash_mutants.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

NAME = 'flash_attention'
LOOSE = dict(atol=3e-2, rtol=3e-2)            # tests/test_kernels.py
# name -> (text of the bf16 kernel, its replacement): first occurrence only,
# which is in flash_bf16
TILE = '    cp_async_commit();\n\n    const int j0 = lo + it * kBk;'
RESCALE = """    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][0] *= corr[0];
        o[nt][1] *= corr[0];
        o[nt][2] *= corr[1];
        o[nt][3] *= corr[1];
      }
    }
"""
MUTANTS = {
    'none': None,
    # the second key tile of a block that walks more than 60 (3840 keys) is
    # skipped after its copies: 64 keys of 3840-4096, which moves a typical
    # output (sigma ~0.026) by ~13 / keys (~3e-3), far under
    # test_kernels.py's 3e-2
    'skip_tile_late': (TILE, TILE.replace(
        '\n\n', '\n    if (it == 1 && n_tiles > 60) continue;\n\n')),
    # the O registers are not rescaled when the running max rises
    'no_rescale': (RESCALE, ''),
    # neither the O registers nor the running sum is rescaled
    'no_correction': ('corr[u] = exp2f(m[u] - m_new);', 'corr[u] = 1.f;'),
}


def compile_all(tmp: Path, name: str = NAME, mutants=None) -> dict:
    """One nvcc per mutant of ``csrc/<name>.cu`` (``mutants``: name ->
    None or (anchor, replacement); default: this script's), all started
    together; mutant -> library path."""
    src = (build.CSRC / f'{name}.cu').read_text()
    procs = {}
    for mut, edit in (MUTANTS if mutants is None else mutants).items():
        text = src
        if edit is not None:
            if edit[0] not in text:
                raise RuntimeError(f'{mut}: its anchor is no longer in '
                                   f'{name}.cu')
            text = text.replace(edit[0], edit[1], 1)
        cu, so = tmp / f'{mut}.cu', tmp / f'{mut}.so'
        cu.write_text(text)
        procs[mut] = (subprocess.Popen(
            build.command(cu, so),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for mut, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {mut}:\n{out}')
        libs[mut] = so
    return libs


def use(path: Path, name: str = NAME) -> None:
    """Make the wrappers of ``csrc/<name>.cu`` launch the library at
    ``path``."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in build.SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    build._LIBS[name] = lib


def passes(check) -> bool:
    try:
        check()
        return True
    except AssertionError:
        return False


def main() -> int:
    smoke.phase_device()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        gen = torch.Generator(device='cuda')
        gen.manual_seed(smoke.SEED)
        try:
            for cfg_name, S, window in smoke.FLASH_CASES:
                ok &= run_case(libs, gen, cfg_name, S, window)
        finally:
            build._LIBS.pop(NAME, None)
    smoke.log(json.dumps({'flash_mutants_ok': bool(ok)}))
    return 0 if ok else 1


def run_case(libs, gen, cfg_name: str, S: int, window: int) -> bool:
    """Every library of ``libs`` on one of chip_smoke's flash shapes;
    True if the unbroken one passes chip_smoke's check and every mutant
    fails it."""
    cfg = get_config(cfg_name)
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.arange(S, dtype=torch.int32, device='cuda')[None]
    q, k, v = (torch.randn((1, S, n, d), generator=gen, device='cuda')
               .to(torch.bfloat16) for n in (H, KV, KV))
    want = flash_attention_plain(q, k, v, pos, window=window)
    ok = True
    for name, path in libs.items():
        use(path)
        got = flash_attention(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        err, share = smoke.flash_error(got, want)
        row = dict(case=f'{cfg_name} S {S} window {window}', mutant=name,
                   max_abs_err=err, limit_share=share,
                   fails_smoke=not passes(lambda: smoke.check_flash(
                       got, want, torch.bfloat16)),
                   fails_3e_2=not passes(lambda: torch.testing.assert_close(
                       got.float(), want.float(), **LOOSE)))
        smoke.log(json.dumps(row))
        ok &= row['fails_smoke'] == (name != 'none')
        del got
    del q, k, v, want
    smoke.free()
    return ok


if __name__ == '__main__':
    sys.exit(main())
