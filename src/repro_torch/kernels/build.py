"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries with
a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own (so several builds can run side
by side) into ``build/kernels/<name>-<hash>.so`` under the repository root,
where the hash covers the source and the flags: an edited source never
reuses a stale library. Nothing is compiled when a module is imported — the
first launch of a kernel (or :func:`build_all`) builds it. There is no
``--use_fast_math``: ``gather_rope`` needs accurate ``sinf``/``cosf`` at
positions of tens of thousands of radians.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code, so a refused launch (too many
threads, too much shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

# every kernel library: C entry point -> ctypes argtypes
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    'embed_gather': {
        # table, ids, out, n, vocab, row_bytes, stream
        'embed_gather': (_P, _P, _P, _I, _I, _L, _P)},
    'gather_rope': {
        # table, ids, pos, inv_freq, out, n, vocab, width, dtype_code,
        # seg_off[4], seg_heads[4], seg_hd[4], seg_inv_off[4], n_segs, stream
        'gather_rope': (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P, _P, _P, _P, _I, _P)},
    'paged_attention': {
        # q, k, v, cpos, table, pos0, out, B, T, KV, G, d, NP, ps, P,
        # scale, window, dtype_code, stream
        'paged_attention': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _I, _I, _P),
        # rows, head_dim -> dynamic shared bytes per block (0: too large)
        'paged_attention_smem': (_I, _I)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path('/usr/local/cuda/bin/nvcc')
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels build only where '
                       'the CUDA toolkit is installed')


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:12]}.so'


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', str(out),
            str(CSRC / f'{name}.cu')]


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns wall seconds per compiled name (0.0 when already
    built). Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    secs: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (BUILD_DIR / f'{name}.log').write_text(log)
        if proc.returncode:
            failed.append(f'--- {name} (exit {proc.returncode})\n{log}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Declares argtypes/restype of every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f'{what}: CUDA error {code} at launch')


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
