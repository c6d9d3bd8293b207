"""Per-step programs of the one-device ``ServingEngine``: the port of the
JAX engine's ``_build_programs`` (``repro/serving/engine.py``): ``step`` /
``step_logits`` / ``chunk_step`` / ``chunk_step_logits`` /
``packed_step`` / ``packed_step_logits``, and ``feed_prev`` for the async
loop.

JAX compiles one executable per step shape. The port keeps one
:class:`StepProgram` per key ``(path, nb, T, want_logits)``, or ``(PACKED,
nb, R, T, want_logits)``:

- ``path``: :data:`STEP`, the dense one-token step with ``lane_valid``;
  :data:`CHUNK`, the chunk step with ``n_valid`` (every paged step); or
  :data:`PACKED`, the segment-packed chunk step, whose tokens are the
  engine's ``_pack_layout`` grid of ``R`` rows (a power of two, at most
  ``nb``) and whose six layout arrays (``attention.PackedLayout``) ride in
  the staged buffer; each slot's last valid hidden sits at lane
  ``seg_row * T + seg_off + n_valid - 1``;
- ``nb``: the dispatch's slot bucket (``ServingEngine._bucket``); ``T``: 1
  or the engine's ``chunk_size``; ``want_logits``: the all-lane head of
  scoring.

A program holds static device inputs: one int32 buffer that
:meth:`StepProgram.stage` fills with one host-to-device copy (tokens,
positions, ``n_valid`` or lane validity, the temperatures as float32 bits
and, paged, the bucket's page tables, the fixed-width pending clears, the
chunk positions and the job lists; each array at a 16-byte offset), and a
float32 buffer of the sampler's uniform noise, drawn from the engine's
generator before every run (``sampler.sample_tokens(noise=...)``). Its
outputs are the sampled tokens, the per-lane finiteness, the MoE drop
count and, with ``want_logits``, the (nb, T, V) logits; its states are
the bucket's views (``ServingEngine._bucket_states``).

**The async loop** (``ServingEngine(async_loop=True)``): the staged buffer
also holds ``use_prev`` (nb,), and the forward first splices the previous
dispatch's sampled token into each such slot's lane (its decode lane:
column 0, or packed lane ``seg_row * T + seg_off``) from the engine's
``_prev_nxt``, a ``max_slots``-wide device buffer that every program writes
its sampled tokens into: a fixed address for the graph, whatever bucket
the previous step ran at. The host then runs one step ahead of the device,
so a program alternates two pinned staging buffers (the copy out of the
other may still wait behind the step in flight), and :meth:`copy_out`
copies the step's outputs into one of two pinned sets with an event, since
the next run of the same program overwrites its static outputs before the
commit reads them. Nothing on this path reads the device.

``run(graphs=True)`` (the engine asks for it on a CUDA device with the
``cuda`` backend and no mesh): the first run of a key runs the forward
eagerly on the static buffers, which is that step's result and loads every
kernel module, cuBLAS handle and ``gather_rope`` frequency vector; then it
captures the forward into a ``torch.cuda.CUDAGraph`` in the engine's graph
memory pool. Later runs replay the graph on the inputs staged into the same
buffers. A capture or replay that fails raises, and so does a forward that
rebinds a state leaf instead of writing it in place (the graph would write
into its private pool). ``run(graphs=False)`` (the CPU, a mesh, the
``reference`` backend on a card, the engine's eager context) runs the
forward on the same static buffers at every step, with no capture.

The kernel wrappers count a launch when Python calls them, which a capture
does once and a replay never: a program takes back the counts its capture
added and adds them at every replay, so each ``launches`` stays the number
of launches executed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.embed_gather import embed_gather
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gather_rope import gather_rope
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_mla,
                                                 paged_attention_quant,
                                                 sharded_paged_attention)
from repro_torch.kernels.paged_maintenance import (cow_page_copy,
                                                   fused_page_write)
from repro_torch.kernels.rmsnorm_qkv import rmsnorm_matmul
from repro_torch.models.attention import PackedLayout, PageTables
from repro_torch.models.transformer import lm_logits
from repro_torch.serving.sampler import sample_tokens

STEP = 'step'       # dense one-token step (lane_valid)
CHUNK = 'chunk'     # chunk step (n_valid); every paged step
PACKED = 'packed'   # segment-packed chunk step
# the kernel wrappers whose ``launches`` a replay adds to
COUNTED = (embed_gather, gather_rope, paged_attention, paged_attention_mla,
           paged_attention_quant, fused_page_write, cow_page_copy,
           rmsnorm_matmul, flash_attention, sharded_paged_attention)
_ALIGN = 4          # int32 words: every staged array starts 16-byte aligned

Key = tuple        # (path, nb, T, want_logits) or (PACKED, nb, R, T, ...)


def _leaves(states) -> list:
    return [leaf for st in states.values()
            for layer in (st if isinstance(st, list) else [st])
            for leaf in layer.values()]


class StepProgram:
    """One step shape's program; see the module docstring. ``arrays``: the
    first step's host arrays (name -> int32 or float32 numpy array), whose
    names, shapes and dtypes every later :meth:`stage` must repeat."""

    def __init__(self, engine, key: Key, arrays: Dict[str, np.ndarray]):
        self.engine, self.key = engine, key
        self.path, self.nb = key[0], key[1]
        self.T, self.want_logits = key[-2], key[-1]
        dev = engine.device
        self.layout, off = [], 0
        for name, a in arrays.items():
            self.layout.append((name, off, a.shape, a.dtype))
            off += -(-a.size // _ALIGN) * _ALIGN
        self.buf = torch.zeros(max(off, 1), dtype=torch.int32, device=dev)
        # the host side of the one copy: pinned, so that it is a DMA; two
        # in turn in the async loop
        self.hosts = [self.buf] if dev.type == 'cpu' else [
            torch.zeros(self.buf.shape, dtype=torch.int32, pin_memory=True)
            for _ in range(2 if engine.async_loop else 1)]
        self._staged = 0
        # the async loop's pinned output copies, two sets in turn
        self._outs = [None, None]
        self._copied = 0
        self.inputs = {}
        for name, o, shape, dtype in self.layout:
            v = self.buf[o:o + int(np.prod(shape))].view(shape)
            self.inputs[name] = v.view(torch.float32) \
                if dtype == np.float32 else v
        self.noise = torch.empty((self.nb, engine.model.cfg.vocab_size),
                                 dtype=torch.float32, device=dev)
        self.paged = self._page_tables()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launch_delta: Dict = {}
        self.capture_ms = 0.0
        self.replays = 0

    # ------------------------------------------------------------ inputs
    def _page_tables(self) -> Optional[PageTables]:
        x, eng = self.inputs, self.engine
        if 'pt' not in x:
            return None
        if 'pending' not in x:
            return PageTables(x['pt'], x['rt'], eng._sc_ring)
        jobs = (x['jobs'], x['pos_t']) if 'jobs' in x else None
        ring = (x['ring_jobs'], x['pos_t']) if 'ring_jobs' in x else None
        return PageTables(x['pt'], x['rt'], eng._sc_ring, x['pending'], jobs,
                          ring)

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        """Pack the step's host arrays into the static input buffer: one
        host-to-device copy (on the CPU, the buffer itself)."""
        if len(arrays) != len(self.layout):
            raise ValueError(f'program {self.key}: staged {sorted(arrays)}, '
                             f'built for {[n for n, *_ in self.layout]}')
        host = self.hosts[self._staged]
        self._staged = (self._staged + 1) % len(self.hosts)
        h = host.numpy()
        for name, o, shape, dtype in self.layout:
            a = arrays[name]
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f'program {self.key}: {name} is {a.shape} '
                                 f'{a.dtype}, built for {shape} {dtype}')
            h[o:o + a.size] = a.reshape(-1).view(np.int32)
        if host is not self.buf:
            # the last copy out of ``host`` is done: the synchronous loop's
            # commit waited for the step it fed; the async loop's waited
            # for the step before that, the last to use this one of two
            self.buf.copy_(host, non_blocking=True)

    # ----------------------------------------------------------- forward
    def _packed(self) -> PackedLayout:
        x = self.inputs
        return PackedLayout(x['seg_row'], x['seg_off'], x['lane_slot'],
                            x['lane_local'], x['lane_pos'],
                            x['lane_valid'].bool())

    def _feed_prev(self, tokens: torch.Tensor,
                   packed: Optional[PackedLayout]) -> torch.Tensor:
        """The async loop's splice (JAX's ``feed_prev``): each slot with
        ``use_prev`` takes the previous dispatch's sampled token from
        ``_prev_nxt`` in its decode lane; on the packed grid the other
        slots scatter into one spare lane past the grid."""
        use = self.inputs['use_prev'].bool()
        prev = self.engine._prev_nxt[:self.nb]
        if packed is None:
            first = torch.where(use, prev, tokens[:, 0])
            return torch.cat([first[:, None], tokens[:, 1:]], dim=1)
        R, T = tokens.shape
        idx = torch.where(use, packed.seg_row.long() * T
                          + packed.seg_off.long(), R * T)
        flat = torch.cat([tokens.reshape(-1), tokens.new_zeros(1)])
        flat = flat.index_put((idx,), torch.where(use, prev, 0))
        return flat[:R * T].view(R, T)

    @torch.no_grad()
    def _forward(self, states):
        """The step on the static inputs -> (sampled tokens (nb,), per-lane
        finiteness (nb,), all-lane logits (nb, T, V), packed (R, T, V), or
        None, MoE dropped token slots (device scalar))."""
        eng, x = self.engine, self.inputs
        model, params, cfg = eng.model, eng.params, eng.model.cfg
        kw = dict(precomputed=eng.precomputed, return_stats=True,
                  attn_backend=eng.attn_backend)
        packed = self._packed() if self.path == PACKED else None
        tokens = x['tokens']
        if eng.async_loop:
            tokens = self._feed_prev(tokens, packed)
        if self.path == STEP:
            logits, _, st = model.decode_step(
                params, tokens, states, x['pos'],
                lane_valid=x['lane_valid'].bool(), **kw)         # (nb,1,V)
            all_logits = logits if self.want_logits else None
        else:
            nv = x['n_valid']
            h, _, st = model.decode_step(
                params, tokens, states, x['pos'], n_valid=nv,
                return_hidden=True, fused_gather_rope=eng.fused_gather_rope,
                paged=self.paged, packed=packed, **kw)
            # head only on each slot's last valid lane, not all T lanes
            last = (nv.long() - 1).clamp(min=0)
            if packed is None:
                h_last = h[torch.arange(h.shape[0], device=h.device), last]
            else:
                R, T = tokens.shape
                h_last = h.reshape((R * T,) + h.shape[2:])[
                    packed.seg_row.long() * T + packed.seg_off.long() + last]
            logits = lm_logits(params, h_last[:, None], cfg)      # (nb,1,V)
            all_logits = lm_logits(params, h, cfg) if self.want_logits \
                else None
        nxt = sample_tokens(logits[:, 0], None, x['temps'], noise=self.noise)
        if eng.async_loop:
            eng._prev_nxt[:self.nb].copy_(nxt)
        finite = torch.isfinite(logits).all(dim=2).all(dim=1)
        return nxt, finite, all_logits, st['moe_drops']

    def copy_out(self, out) -> tuple:
        """Non-blocking copies of a run's outputs into one of this
        program's two pinned sets, and an event recorded after them.
        -> ((nxt, finite, logits, drops) on the host, the event)."""
        i = self._copied
        self._copied ^= 1
        if self._outs[i] is None:
            self._outs[i] = [None if t is None else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True) for t in out]
        host = self._outs[i]
        for h, t in zip(host, out):
            if t is not None:
                h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return tuple(host), event

    def run(self, graphs: bool):
        """Draw the sampler's noise and run the step: eagerly, or (with
        ``graphs``) by capture on a key's first run and replay after it.
        -> the :meth:`_forward` tuple (a replay's: the graph's static
        outputs, valid until the next run of this program)."""
        eng = self.engine
        torch.rand(self.noise.shape, generator=eng.generator,
                   device=self.noise.device, out=self.noise)
        if not graphs:
            return self._forward(eng._bucket_states(self.nb))
        if self.graph is None:
            out = self._forward(eng._bucket_states(self.nb))
            self._capture()
            return out
        self.graph.replay()
        self.replays += 1
        for fn, n in self.launch_delta.items():
            fn.launches += n
        return self.outputs

    def _capture(self) -> None:
        eng = self.engine
        states = eng._bucket_states(self.nb)
        leaves = _leaves(states)
        ptrs = [leaf.data_ptr() for leaf in leaves]
        counts = {fn: fn.launches for fn in COUNTED}
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no collection inside the capture: it could destroy a dead
        # engine's graphs, a call that invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=eng._graph_pool):
                out = self._forward(states)
        finally:
            if collecting:
                gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        if [leaf.data_ptr() for leaf in _leaves(states)] != ptrs:
            raise RuntimeError(
                f'program {self.key}: the forward rebound a state leaf '
                'instead of writing it in place; a replay would write into '
                'the graph\'s own memory')
        # the capture ran no kernel: take its counts back, add them per replay
        self.launch_delta = {fn: fn.launches - counts[fn] for fn in COUNTED
                             if fn.launches != counts[fn]}
        for fn, n in self.launch_delta.items():
            fn.launches -= n
        self.graph, self.outputs = graph, out
