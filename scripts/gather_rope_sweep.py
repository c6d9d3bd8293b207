"""Times ``gather_rope``'s kernel with 32, 64 or 128 threads a block (the
source built once more for each, with ``GATHER_ROPE_THREADS`` defined)
against the kernel's own rule by token count (the wrapper's library) at N
1, 4, 64 and 512 for the mistral-7b, glm4-9b and deepseek-v2-lite-16b row
layouts, bf16 tables of the full vocabulary, so that the rule rests on a
measurement. Device ms per call as chip_smoke.py times every kernel
(CUDA-graph replays), each setting in two rounds in mirrored order,
beside one launch of an empty kernel. Needs one CUDA card.

    python3 scripts/gather_rope_sweep.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / 'src')]

import chip_smoke as S  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gather_rope as GR  # noqa: E402

SETTINGS = (0, 32, 64, 128)     # 0: the kernel's rule


def libraries() -> dict:
    """threads -> the loaded gather_rope library (0: the wrapper's)."""
    procs = {}
    for t in SETTINGS[1:]:
        out = build.library_path('gather_rope').with_suffix(
            f'.threads{t}.so')
        cmd = build.command(build.CSRC / 'gather_rope.cu', out)
        procs[t] = (subprocess.Popen(cmd[:1] + [f'-DGATHER_ROPE_THREADS={t}']
                                     + cmd[1:]), out)
    libs = {0: build.load('gather_rope')}
    for t, (proc, out) in procs.items():
        if proc.wait():
            raise RuntimeError(f'nvcc failed for {t} threads a block')
        libs[t] = ctypes.CDLL(str(out))
        fn = libs[t].gather_rope
        fn.argtypes = list(build.SIGNATURES['gather_rope']['gather_rope'])
        fn.restype = ctypes.c_int
    return libs


def launch(lib, table, ids, pos, out, segs, theta) -> None:
    """The wrapper's launch, through ``lib``, into ``out``."""
    hds, offs, heads, widths, ioff = GR._seg_args(segs)
    inv = GR.inverse_frequencies(hds, theta, table.device)
    V, W = table.shape
    build.check(lib.gather_rope(
        table.data_ptr(), ids.data_ptr(), pos.data_ptr(), inv.data_ptr(),
        out.data_ptr(), ids.shape[0], V, W, 1,
        *(ctypes.cast(a, ctypes.c_void_p) for a in (offs, heads, widths,
                                                     ioff)),
        len(segs), build.stream_of(table)), 'gather_rope')


def main() -> None:
    S.phase_device()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    build.build_all(['gather_rope', 'launch_floor'])
    libs = libraries()
    gen = torch.Generator(device='cuda').manual_seed(S.SEED)
    S.launch_floor_ms()
    for name in ('mistral_7b', 'glm4_9b', S.DS):
        cfg = get_config(name)
        V, W = cfg.vocab_size, cfg.precompute_row_width
        segs = GR._check_segs(S.rope_segments(cfg), W)
        table = torch.randn((V, W), generator=gen,
                            device='cuda').to(torch.bfloat16)
        for n in (1, 4, 64, 512):
            ids = torch.randint(0, V, (n,), generator=gen, device='cuda',
                                dtype=torch.int32)
            pos = torch.randint(0, 32768, (n,), generator=gen, device='cuda',
                                dtype=torch.int32)
            out = torch.empty((n, W), dtype=table.dtype, device='cuda')
            ms = {t: [] for t in SETTINGS}
            for t in SETTINGS + SETTINGS[::-1]:
                ms[t].append(S.time_ms(lambda: launch(
                    libs[t], table, ids, pos, out, segs, cfg.rope_theta)))
            S.log(f'[sweep] gather_rope {cfg.name} bf16 N={n}: ' + ', '.join(
                f'{t or "rule"} {a:.4f} / {b:.4f} ms'
                for t, (a, b) in ms.items()))
        del table
        S.free()


if __name__ == '__main__':
    main()
