"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries with
a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own (so several builds can run side
by side) into ``build/kernels/<name>-<hash>.so`` under the repository root,
where the hash covers the source, the shared headers ``csrc/*.cuh`` and the
flags: an edited source or header never reuses a stale library. Nothing is
compiled when a module is imported — the first launch of a kernel (or
:func:`build_all`) builds it. There is no
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
        # table, ids, out, n, vocab, row_bytes, NaN word, stream
        'embed_gather': (_P, _P, _P, _I, _I, _L, _I, _P)},
    'gather_rope': {
        # table, ids, pos, inv_freq, out, n, vocab, width, dtype_code,
        # seg_off[n_segs], seg_heads[n_segs], seg_hd[n_segs],
        # seg_inv_off[n_segs], n_segs, stream
        'gather_rope': (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P, _P, _P, _P, _I, _P)},
    'paged_attention': {
        # q, k, v, cpos, table, pos0, out, B, T, KV, G, d, NP, ps, P,
        # scale, window, q_code, kv_code, stream
        'paged_attention': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _I, _I, _I, _P),
        # q, ckv, kpe, cpos, table, pos0, out, B, T, H, r, dr, NP, ps, P,
        # scale, window, q_code, kv_code, stream
        'paged_attention_mla': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _F, _I, _I, _I, _P),
        # q, k, v, k_scale, v_scale, cpos, table, pos0, out, B, T, KV, G,
        # d, NP, ps, P, scale, window, q_code, stream
        'paged_attention_quant': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
        # rows, q width, value width, form (0 dense, 1 MLA, 2 int8) ->
        # dynamic shared bytes per block (0: too large)
        'paged_attention_smem': (_I, _I, _I, _I),
        # q, k, v, cpos, table, pos0, workspace, out, B, T, KV, G, d, NP,
        # ps, P, scale, window, stream (dense form, bf16, keys in chunks)
        'paged_attention_split': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _F, _I, _P),
        # q, ckv, kpe, cpos, table, pos0, workspace, out, B, T, H, r, dr,
        # NP, ps, P, scale, window, stream (MLA form, fp32 q over bf16
        # pages, keys in chunks)
        'paged_attention_mla_split': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _F, _I, _P),
        # q, k, v, k_scale, v_scale, cpos, table, pos0, workspace, out, B,
        # T, KV, G, d, NP, ps, P, scale, window, stream (int8 form, bf16 q,
        # keys in chunks)
        'paged_attention_quant_split': (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _F, _I, _P),
        # B, KV, rows T*G, keys P*ps -> key chunk length of the split forms
        'paged_attention_split_chunk': (_I, _I, _I, _I)},
    'fused_page_write': {
        # pools[n], vals[n], strides[2n], row_bytes[n], fills[n], n,
        # quant[4 n_quant], n_quant, jobs, n_jobs, NP, B, ps, Sc, stream
        'fused_page_write': (_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I,
                             _I, _I, _P)},
    'rmsnorm_matmul': {
        # x, scale, w0, w1, w2, out0, out1, out2, W0, W1, W2, n_mats, N, d,
        # eps, dtype_code, form, workspace, workspace bytes, stream
        'rmsnorm_matmul': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _P, _L, _P),
        # w0, w1, w2, W0, W1, W2, n_mats, N, d, dtype_code, wanted form
        # (-1: by shape), &workspace bytes -> form (-1: not allowed)
        'rmsnorm_matmul_plan': (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P)},
    'flash_attention': {
        # q, k, v, pos, out, B, S, H, KV, d, causal, window, scale,
        # dtype_code, stream
        'flash_attention': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _I, _P)},
    'cow_page_copy': {
        # pools[n], n_pages[n], row_bytes[n], fills[n], n, sdr, n_jobs, ps,
        # stream
        'cow_page_copy': (_P, _P, _P, _P, _I, _P, _I, _I, _P)},
    'launch_floor': {
        # stream (an empty kernel: the cost of one launch, for chip_smoke)
        'launch_floor': (_P,)},
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
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f'{name}.cu').read_bytes() + b''.join(
        h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:12]}.so'


def command(src: Path, out: Path) -> List[str]:
    """The nvcc command that builds ``src`` (which may lie outside
    ``csrc/``; it finds the shared headers there) into ``out``."""
    return [nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-Xptxas', '-v', '-o',
            str(out), str(src)]


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
            command(CSRC / f'{name}.cu', tmp), stdout=subprocess.PIPE,
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
