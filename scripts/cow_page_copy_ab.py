"""Times ``cow_page_copy``'s kernel as another checkout builds it (for
example the parent commit, unpacked with ``git archive``) against this
checkout's, in one process on one card, at glm4-9b's pages (2 kv heads x
128, bf16 and fp32 k / v / pos over 39 stacked layers, the engine's pool
of 1537 pages) and at pythia-6.9b's (32 kv heads x 128, bf16 k / v / pos
and the five int8 leaves over 31 stacked layers), rem 0, 7 and 16; the
leaves and jobs are ``chip_smoke.py``'s (``cow_leaves``, ``layer_jobs``).
Each build is first held bitwise against the plain version. Device ms per
call as chip_smoke.py times every kernel (CUDA-graph replays), in the
order other, this, this, other; at pythia's pages also with eight job
sets of other pages in turn (``chip_smoke.fresh_cow_ms``: about 94 MB a
round at bf16 rem 7, beyond the 50 MB L2). Prints the bound beside each.
Needs one CUDA card.

    python3 scripts/cow_page_copy_ab.py OTHER_CHECKOUT
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
from repro_torch.kernels import paged_maintenance as PM  # noqa: E402

SHAPES = (('glm4_9b', ('bf16', 'fp32'), None),        # None: the engine's pool
          ('pythia_6_9b', ('bf16', 'int8'), S.PYTHIA_COW_NP))


def libraries(other: Path) -> dict:
    """label -> a loaded cow_page_copy library, built from ``other``'s
    source and this checkout's, both at once."""
    srcs = {'other': other / 'src/repro_torch/csrc/cow_page_copy.cu',
            'this': build.CSRC / 'cow_page_copy.cu'}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in srcs.items():
        out = build.BUILD_DIR / f'cow_ab_{label}.so'
        procs[label] = (subprocess.Popen(build.command(src, out)), out)
    libs = {}
    for label, (proc, out) in procs.items():
        if proc.wait():
            raise RuntimeError(f'nvcc failed for {label}')
        lib = ctypes.CDLL(str(out))
        lib.cow_page_copy.argtypes = list(
            build.SIGNATURES['cow_page_copy']['cow_page_copy'])
        lib.cow_page_copy.restype = ctypes.c_int
        libs[label] = lib
    return libs


def launch(lib, pools, sdr, fills) -> None:
    """The wrapper's launch (``PM.cow_page_copy``) through ``lib``."""
    n = len(pools)
    build.check(lib.cow_page_copy(
        (ctypes.c_void_p * n)(*[p.data_ptr() for p in pools]),
        (ctypes.c_longlong * n)(*[p.shape[0] for p in pools]),
        (ctypes.c_int * n)(*[p[0, 0].numel() * p.element_size()
                             for p in pools]),
        (ctypes.c_uint * n)(*[PM._fill_bits(p, f)
                              for p, f in zip(pools, fills)]),
        n, sdr.data_ptr(), sdr.shape[0], pools[0].shape[1],
        build.stream_of(sdr)), 'cow_page_copy')


def main() -> None:
    other = Path(sys.argv[1]).resolve()
    S.phase_device()
    libs = libraries(other)
    order = list(libs) + list(libs)[::-1]
    gen = torch.Generator(device='cuda').manual_seed(S.SEED)
    ps = S.GLM_PS
    for arch, kinds, NP in SHAPES:
        NP = NP or S.glm_pool_pages()
        name = get_config(arch).name
        for kind in kinds:
            names, pools, fills, reps = S.cow_leaves(gen, arch, kind, NP)
            rb = [x[0, 0].numel() * x.element_size() for x in pools]
            for rem in (0, 7, ps):
                sdr = S.layer_jobs(reps, NP, 11, 40, rem)
                want = [PM.cow_page_copy_plain(x.clone(), sdr, fill=f)
                        for x, f in zip(pools, fills)]
                for label, lib in libs.items():
                    launch(lib, pools, sdr, fills)
                    torch.cuda.synchronize()
                    for nm, g, w in zip(names, pools, want):
                        assert torch.equal(g, w), (arch, kind, rem, label, nm)
                del want
                moved = reps * sum((rem + ps) * b for b in rb) \
                    + S.nbytes(sdr)
                b_ms, by = S.bound(moved, 0, torch.bfloat16)
                ms = {label: [] for label in libs}
                for label in order:
                    ms[label].append(S.time_ms(
                        lambda: launch(libs[label], pools, sdr, fills)))
                text = ', '.join(f'{lb} {a:.4f} / {b:.4f} ms'
                                 for lb, (a, b) in ms.items())
                S.log(f'[ab] cow_page_copy {name} {kind} {"/".join(names)} '
                      f'rem={rem} over {reps} layers (NP={NP}, {moved} '
                      f'bytes): bitwise equal for both; same pages every '
                      f'replay: {text}; bound {b_ms:.6f} ms ({by})')
                if arch != 'pythia_6_9b':
                    continue
                fresh = {label: [] for label in libs}
                for label in order:
                    fresh[label].append(S.fresh_cow_ms(
                        lambda sdr: launch(libs[label], pools, sdr, fills),
                        reps, NP, rem))
                text = ', '.join(f'{lb} {a:.4f} / {b:.4f} ms'
                                 for lb, (a, b) in fresh.items())
                S.log(f'[ab] cow_page_copy {name} {kind} rem={rem}, 8 job '
                      f'sets of other pages in turn (pages new to the L2): '
                      f'{text}; bound {b_ms:.6f} ms ({by})')
            del pools
            S.free()


if __name__ == '__main__':
    main()
