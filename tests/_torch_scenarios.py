"""Engine scenarios of the port shared by its CPU tests and their
``cuda``-marked twins; imports nothing of JAX, so the twins run on a card
where only the port is installed."""
import contextlib

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.engine import (Request, RequestStatus, ServingEngine,
                                        _eager_steps)


def paged_gqa_config() -> ModelConfig:
    """The ``paged-gqa`` config of ``tests/test_paged_prefix.py``."""
    return ModelConfig(name='paged-gqa', arch_class='dense', num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=211, max_seq_len=256,
                       dtype='float32')


def perturbed(tree, seed: int = 5):
    """A numpy copy of a parameter tree with norm scales 1 + 0.1 N(0, 1)
    and biases 0.1 N(0, 1) (leaves named ``scale``, ``bias`` and ``b``),
    so that no norm or bias is the identity."""
    rng = np.random.default_rng(seed)

    def walk(node, name=''):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        a = np.array(node)
        if name == 'scale':
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name in ('bias', 'b'):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(tree)


def _serve(eng, prompts, new_tokens=6):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.status is RequestStatus.FINISHED for r in reqs)
    return [r.generated for r in reqs]


def cow_retaken_run(device, backend, kv_quant):
    """A page freed and taken again in one admission pass, then copied on
    write. Page size 4, chunk 4, 2 slots. The cache is warmed with
    a+b+c+[7] (blocks a, b, c published); then A = a+[200,201,202] and
    B = a+b[:2]+[9] are admitted in one pass. A's tail page X finds no
    cached extension and is freed; B takes X again (the free list is LIFO)
    and copies the head of block b into it. -> (A's and B's greedy tokens,
    the dense engine's for the same prompts, what B's admission saw:
    ``_pending_clear`` before and after, whether it copied, its page)."""
    model = Model(paged_gqa_config())
    params = model.init(0, device=device, dtype=torch.float32)
    a, b, c = np.random.default_rng(11).integers(3, 200, (3, 4)) \
        .astype(np.int32)
    warm = np.concatenate([a, b, c, [7]]).astype(np.int32)
    prompts = [np.concatenate([a, [200, 201, 202]]).astype(np.int32),
               np.concatenate([a, b[:2], [9]]).astype(np.int32)]

    def engine(**kw):
        return ServingEngine(model, params, max_slots=2, max_seq=32,
                             chunk_size=4, kv_quant=kv_quant,
                             attn_backend=backend, dtype=torch.float32,
                             device=device, **kw)

    eng = engine(prefix_cache=True, page_size=4)
    _serve(eng, [warm])
    seen = {}
    admit = eng._admit_paged

    def spy(slot, req, stream):
        before = list(eng._pending_clear)
        copies = eng.cow_copies
        ok = admit(slot, req, stream)
        if req.uid == 1:
            seen.update(before=before, after=list(eng._pending_clear),
                        cow=eng.cow_copies > copies,
                        page=eng.slot_priv[slot][0] if eng.slot_priv[slot]
                        else None)
        return ok
    eng._admit_paged = spy
    return _serve(eng, prompts), _serve(engine(), prompts), seen


def replay_vs_eager_run(device):
    """A 16-slot paged engine (``paged-gqa``, fp32, page 4, chunk 4, the
    ``cuda`` backend) twice: as it runs, and inside ``_eager_steps()``. Two
    waves of 3 requests (the second holds a prefix hit and a prompt that
    stops inside a cached page: a copy-on-write), then ``score()`` of one
    prompt; every dispatch is at bucket 8. On a card the first engine's
    programs capture CUDA graphs and replay them. -> (outcome, the eager
    engine's outcome, {'buckets', 'graphs', 'replays'} of the first
    engine's programs); an outcome is the greedy tokens, the score logits'
    bytes and every pool leaf's bytes, so ``==`` compares them bitwise."""
    model = Model(paged_gqa_config())
    params = model.init(0, device=device, dtype=torch.float32)
    rng = np.random.default_rng(13)
    a, b, c = (rng.integers(3, 200, n).astype(np.int32) for n in (13, 9, 6))
    waves = [[a, b, c], [np.concatenate([a, [5, 6]]).astype(np.int32),
                         a[:10].copy(), b]]
    scored = rng.integers(3, 200, 7).astype(np.int32)

    def run(eager):
        eng = ServingEngine(model, params, max_slots=16, max_seq=32,
                            chunk_size=4, prefix_cache=True, page_size=4,
                            attn_backend='cuda', dtype=torch.float32,
                            device=device)
        with _eager_steps() if eager else contextlib.nullcontext():
            tokens = [_serve(eng, w) for w in waves]
            logits = [x.tobytes() for x in eng.score([scored])]
        assert eng.cow_copies > 0 and eng.kv.hits > 0
        pools = [leaf.cpu().numpy().tobytes()
                 for pool, _ in eng._pools for leaf in pool.values()]
        return (tokens, logits, pools), eng

    got, eng = run(False)
    want, _ = run(True)
    progs = eng.programs.values()
    return got, want, {'buckets': {k[1] for k in eng.programs},
                       'graphs': sum(p.graph is not None for p in progs),
                       'replays': sum(p.replays for p in progs)}


def async_packed_vs_eager_run(device):
    """The waves and scoring of :func:`replay_vs_eager_run` on a 16-slot
    paged engine (``paged-gqa``, fp32, page 4, chunk 4, the ``cuda``
    backend) with ``pack_prefill=True, async_loop=True``, against the same
    engine without either inside ``_eager_steps()``. On a card the first
    engine replays CUDA graphs one step ahead of the host. -> (tokens, the
    eager run's tokens, score logits, the eager run's, {'packed' (packed
    program keys), 'graphs', 'replays'})."""
    model = Model(paged_gqa_config())
    params = model.init(0, device=device, dtype=torch.float32)
    rng = np.random.default_rng(13)
    a, b, c = (rng.integers(3, 200, n).astype(np.int32) for n in (13, 9, 6))
    waves = [[a, b, c], [np.concatenate([a, [5, 6]]).astype(np.int32),
                         a[:10].copy(), b]]
    scored = rng.integers(3, 200, 7).astype(np.int32)

    def run(fast):
        eng = ServingEngine(model, params, max_slots=16, max_seq=32,
                            chunk_size=4, prefix_cache=True, page_size=4,
                            attn_backend='cuda', dtype=torch.float32,
                            pack_prefill=fast, async_loop=fast,
                            device=device)
        with contextlib.nullcontext() if fast else _eager_steps():
            tokens = [_serve(eng, w) for w in waves]
            logits = eng.score([scored])
        assert eng._pending is None and eng.kv.hits > 0
        return tokens, logits, eng

    got, got_logits, eng = run(True)
    want, want_logits, _ = run(False)
    progs = eng.programs.values()
    return got, want, got_logits, want_logits, {
        'packed': sorted(k for k in eng.programs if k[0] == 'packed'),
        'graphs': sum(p.graph is not None for p in progs),
        'replays': sum(p.replays for p in progs)}


def oov_prompts(vocab: int, seed: int = 0):
    """The out-of-vocabulary case of ROADMAP C1: a 7-token prompt with the
    id ``vocab + 5`` at index 3 (508 for V 503), its clean twin, the twin
    with id -1 at index 2 (row V - 1, as ``jnp.take`` reads it) and another
    clean prompt."""
    rng = np.random.default_rng(seed)
    base = rng.integers(3, vocab, 7).astype(np.int32)
    bad, neg = base.copy(), base.copy()
    bad[3] = vocab + 5
    neg[2] = -1
    return [bad, base, neg, rng.integers(3, vocab, 6).astype(np.int32)]


def serve_outcomes(eng, req_cls, prompts, new_tokens=4):
    """(status name, error, greedy tokens) of each prompt served by one
    ``run()``; ``req_cls`` is the port's or the JAX engine's request."""
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [(r.status.name, r.error, list(r.generated)) for r in reqs]


def clean_after_failed(engine, vocab):
    """One slot: the out-of-vocabulary prompt, then a clean one in the slot
    (and, paged, on the pages) it left. ``engine()`` makes a fresh one-slot
    engine. -> (both outcomes, the clean prompt's outcome on a fresh
    engine, pages the failed request held, pages the clean one took)."""
    prompts = oov_prompts(vocab)
    bad, clean = prompts[0], prompts[3]
    eng = engine()
    taken = []
    if eng.paged:
        alloc = eng.kv.alloc

        def spy(n):               # before the failure: the failed one's
            got = alloc(n)
            taken.append((eng.n_failed, got or []))
            return got
        eng.kv.alloc = spy
    after = serve_outcomes(eng, Request, [bad, clean])
    fresh = serve_outcomes(engine(), Request, [clean])
    pages = [{p for failed, got in taken if failed == k for p in got}
             for k in (0, 1)]
    return after, fresh, pages


# ------------------------------------------- the quantizing page write
# An amax (a bf16 value) whose scale differs by one ulp between amax / 127
# and amax * fl(1 / 127): for its half, x / scale rounds to 63 by the one
# and to 64 by the other
DIVISION_AMAX = 0.008728027


def quant_edge_rows(rng, hd: int) -> np.ndarray:
    """(5, hd) float32 rows, every value a bf16 value, that test the
    quantizer's bits: one NaN (the whole row gives 0 and a NaN scale); all
    zeros (the 1e-8 scale floor); amax 127 (scale exactly 1) with values on
    .5 boundaries (round half to even); bf16's largest finite values; and
    ``DIVISION_AMAX`` with its half and minus its half."""
    rows = np.zeros((5, hd), np.float32)
    rows[0] = rng.standard_normal(hd)
    rows[0, hd // 3] = np.nan
    ties = np.arange(hd) % 9 - 4.5
    rows[2] = np.where(np.arange(hd) % 2 == 0, ties, -ties)
    rows[2, 0], rows[2, -1] = 127, 126.5
    big = np.float32(torch.finfo(torch.bfloat16).max)
    rows[3] = big * np.sign(rng.standard_normal(hd))
    rows[3, 1::2] /= 3
    a = np.float32(DIVISION_AMAX)
    rows[4] = rng.uniform(-a / 4, a / 4, hd)
    rows[4, :3] = [a, a / 2, -a / 2]
    return torch.from_numpy(rows).to(torch.bfloat16).float().numpy()


def quant_write_case(seed: int, *, ps: int, Sc: int, T: int, KV: int,
                     hd: int):
    """One layer's int8 pool leaves and a chunk write into them: slot 0
    wraps the ring of ``Sc`` entries (merge pages; a last page past the
    ring's end when Sc is not a page multiple), slot 1 starts on a fresh
    page awaiting its clear (mode 1), slot 2 writes one lane; two more
    pending pages are cleared whole (mode 2) and a 0 pads the pending
    list. The float K/V values (B, T, KV, hd) carry
    :func:`quant_edge_rows`; the NaN row is the only lane written from its
    slot. -> (pool leaves as numpy arrays, keyed as the cache; K and V as
    float32 numpy arrays; pos0, n_valid, table, pending as int32 numpy
    arrays)."""
    rng = np.random.default_rng(seed)
    B = 3
    P = -(-Sc // ps)
    NP = 1 + B * P + 3
    lead = (NP, ps)
    scale = np.abs(rng.standard_normal(lead + (KV,))) * 0.05 + 1e-3
    pool = {'k': rng.integers(-127, 128, lead + (KV, hd)).astype(np.int8),
            'v': rng.integers(-127, 128, lead + (KV, hd)).astype(np.int8),
            'k_scale': torch.from_numpy(scale).to(torch.bfloat16).float()
            .numpy(),
            'v_scale': torch.from_numpy(scale[::-1].copy())
            .to(torch.bfloat16).float().numpy(),
            'pos': rng.integers(0, 99, lead).astype(np.int32)}
    for nm in pool:
        pool[nm][0] = -1 if nm == 'pos' else 0
    table = (rng.permutation(B * P) + 1).reshape(B, P).astype(np.int32)
    pos0 = np.array([Sc - 2, 0, 5 % Sc], np.int32)
    n_valid = np.array([T, T, 1], np.int32)
    pending = np.array([table[1, 0], NP - 1, NP - 2, 0], np.int32)
    x = (rng.standard_normal((2, B, T, KV, hd)) * 2).astype(np.float32)
    edge = quant_edge_rows(rng, hd)
    x[0, 2, 0, 0] = edge[0]                      # NaN: slot 2's one lane
    x[0, 0, min(1, T - 1), KV - 1] = edge[1]     # zeros
    x[1, 0, 0, 0] = edge[2]                      # ties
    x[0, 1, 0, 0] = edge[3]                      # bf16's largest
    x[1, 1, T - 1, KV - 1] = edge[4]             # division
    return pool, x[0], x[1], pos0, n_valid, table, pending
