"""Engine scenarios of the port shared by its CPU tests and their
``cuda``-marked twins; imports nothing of JAX, so the twins run on a card
where only the port is installed."""
import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, RequestStatus, ServingEngine


def paged_gqa_config() -> ModelConfig:
    """The ``paged-gqa`` config of ``tests/test_paged_prefix.py``."""
    return ModelConfig(name='paged-gqa', arch_class='dense', num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=211, max_seq_len=256,
                       dtype='float32')


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
