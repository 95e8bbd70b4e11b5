"""Batched cold admission, on the CPU.

An admission pass collects its cold prompts (no warm donor, no extras)
and chunk-prefills them as the rows of as few ``prefill_with_cache``
calls as fit the engine's padded-token budget.  These tests serve the
qwen3 smoke config in float32 on ``device="cpu"``: the tokens of a pass
prefilled in batches equal those of each request admitted alone
(``max_batch=1``), across bucket edges, a pass split by the budget,
priorities with a coalesced duplicate and prompts that share a prefix
inside one pass; an MoE model, whose rows are not independent, keeps one
row a call; a small pool counts the pages of the rows a pass has
collected before any of them is written.  No JAX here.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DENSE = get_smoke("qwen3-1.7b").replace(dtype="float32")
MOE = get_smoke("deepseek-moe-16b").replace(dtype="float32")
WINDOW = 0.3            # seconds: the submissions form one admission pass


def _prompt(n, base):
    return [(base + 7 * i) % 250 + 1 for i in range(n)]


# each case: requests as (prompt, max_new, temperature, priority), and the
# padded-token budget the batched engine runs under (None: the engine's)
STRADDLE = [(_prompt(n, 11 * n), 5, 0.0, 0) for n in (15, 16, 17, 31, 33)]
SPLIT = [(_prompt(n, 3 * n), 4, 0.0, 0)
         for n in (9, 14, 16, 18, 23, 30, 32, 35, 40, 47)]
PRIORITY = [(_prompt(12, 1), 6, 0.0, 0), (_prompt(20, 2), 4, 0.0, 2),
            (_prompt(12, 1), 6, 0.0, 1),              # coalesced duplicate
            (_prompt(27, 3), 5, 0.8, 0), (_prompt(7, 4), 3, 0.0, 1)]
SHARED = [(_prompt(20, 5), 4, 0.0, 0), (_prompt(20, 5)[:12] + [9, 9], 4,
                                        0.0, 0),
          (_prompt(18, 6), 4, 0.0, 0), (_prompt(25, 8), 3, 0.0, 0),
          (_prompt(9, 12), 5, 0.0, 0)]
CASES = {"straddle": (STRADDLE, None), "split": (SPLIT, 64),
         "priority": (PRIORITY, None), "shared_prefix": (SHARED, None)}


def _spy_calls(eng):
    """Record each prefill_with_cache call's (rows, padded tokens)."""
    shapes = []
    orig = eng.model.prefill_with_cache

    def spy(tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return orig(tokens, *a, **kw)

    eng.model.prefill_with_cache = spy
    return shapes


def _serve(cfg, requests, budget=None, **kw):
    eng = InferenceEngine(cfg, seed=0, device="cpu", **kw)
    eng.load()
    if budget is not None:
        eng._PF_BUDGET = budget
    shapes = _spy_calls(eng)
    try:
        handles = [eng.submit(p, max_new_tokens=m, temperature=t, priority=pr)
                   for p, m, t, pr in requests]
        out = [h.result() for h in handles]
        eng.drain()
        return out, eng.stats.as_dict(), shapes
    finally:
        eng.shutdown()


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_batched_pass_gives_each_requests_lone_tokens(case):
    requests, budget = CASES[case]
    alone, st1, shapes1 = _serve(DENSE, requests, max_batch=1)
    out, st, shapes = _serve(DENSE, requests, budget, max_batch=16,
                             admission_window=WINDOW)
    assert out == alone
    assert all(len(o) == r[1] for o, r in zip(out, requests))
    assert st["admission_waves"] == 1
    assert st["prefill_rows"] == st1["prefill_rows"] == \
        len(requests) - st["coalesced_requests"]
    assert st["span_n.engine.admit.model"] == len(shapes)
    assert all(b == 1 for b, _ in shapes1)
    # the shared prefix is found inside the pass as it is one at a time
    assert st["prefix_hits"] == st1["prefix_hits"]
    assert st["prefill_tokens"] == st1["prefill_tokens"]
    # fewer calls than rows, each within the budget unless alone
    assert len(shapes) < st["prefill_rows"]
    limit = budget or InferenceEngine._PF_BUDGET
    assert all(b * t <= limit or b == 1 for b, t in shapes)
    if case == "split":
        assert len(shapes) > 1 + st["prefix_hits"]
    if case == "priority":
        assert st["coalesced_requests"] == 1 and st["priority_jumps"] >= 1
    if case == "shared_prefix":
        assert st["prefix_hits"] == 1


def test_an_moe_engine_keeps_one_row_a_call():
    """Each row at its own bucket, alone: an MoE layer's capacity follows
    the chunk's padded length and grouping.  A decode step of up to 16
    rows drops nothing, so the tokens equal each request's alone."""
    requests = STRADDLE[:4]
    alone, _, _ = _serve(MOE, requests, max_batch=1)
    out, st, shapes = _serve(MOE, requests, max_batch=8,
                             admission_window=WINDOW)
    assert out == alone
    assert st["admission_waves"] == 1
    assert st["prefill_rows"] == st["span_n.engine.admit.model"] \
        == len(shapes) == len(requests)
    q = InferenceEngine._PF_QUANTUM
    assert sorted(shapes) == sorted((1, -(-len(p) // q) * q)
                                    for p, _, _, _ in requests)


def test_a_small_pool_counts_the_collected_rows_pages():
    """16 pages of 8: a 30-token prompt with 24 new tokens reserves 8, so
    a pass collects two and defers the third before any is written;
    without that count it would collect all four, and their decode would
    run out of pages."""
    requests = [(_prompt(30, 10 * i), 24, 0.0, 0) for i in range(4)]
    big, _, _ = _serve(DENSE, requests, max_batch=4)
    out, st, shapes = _serve(DENSE, requests, max_batch=4, num_pages=16,
                             admission_window=WINDOW)
    assert out == big
    assert st["admit_deferrals"] >= 1
    assert shapes[0][0] == 2
    assert st["prefill_rows"] == 4


def _outcomes(handles):
    """Each handle's tokens, or the type of the error it failed with."""
    out = []
    for h in handles:
        try:
            out.append(h.result())
        except Exception as e:       # noqa: BLE001 - the outcome compared
            out.append(type(e))
    return out


def _run_passes(passes, **kw):
    """Serve ``passes`` (lists of requests as in CASES), each submitted
    after the one before has finished; returns every request's outcome,
    the stats and the engine's pool after the last."""
    eng = InferenceEngine(DENSE, seed=0, device="cpu", **kw)
    eng.load()
    try:
        out = []
        for requests in passes:
            out += _outcomes([eng.submit(p, max_new_tokens=m, temperature=t,
                                         priority=pr)
                              for p, m, t, pr in requests])
            eng.drain()
        warm, live = set(eng._warm), set(eng.kv.sequences)
        return out, eng.stats.as_dict(), (warm, live)
    finally:
        eng.shutdown()


def test_a_lone_admission_keeps_its_donor_when_a_collected_row_retires():
    """One warm sequence W.  In one pass a cold prompt that asks for one
    token is collected, then a prompt that extends W's takes W as donor.
    The cold row retires on its first token and, the warm set being full,
    evicts the least recent warm sequence, W: the donor must be used
    before that."""
    w = _prompt(20, 5)
    passes = [[(w, 3, 0.0, 0)],
              [(_prompt(14, 40), 1, 0.0, 0), (w[:16] + [3, 4, 5], 4, 0.0, 0)]]
    alone, _, _ = _run_passes(passes, max_batch=1, max_warm_sequences=1)
    out, st, _ = _run_passes(passes, max_batch=8, max_warm_sequences=1,
                             admission_window=WINDOW)
    assert all(isinstance(o, list) for o in alone)
    assert out == alone
    assert st["prefix_hits"] == 1 and st["warm_evictions"] >= 1


def test_a_bad_prompt_fails_only_its_own_request():
    """A prompt with an id past the vocabulary, in one group with two
    good prompts: the group's call raises, its rows are prefilled one a
    call, and only the bad request fails, with its pages returned."""
    good = [(_prompt(13, 60), 4, 0.0, 0), (_prompt(15, 70), 4, 0.0, 0)]
    bad = (_prompt(12, 80)[:-1] + [10 ** 6], 4, 0.0, 0)
    requests = [good[0], bad, good[1]]
    alone, _, _ = _run_passes([requests], max_batch=1)
    out, st, (warm, live) = _run_passes([requests], max_batch=8,
                                        admission_window=WINDOW)
    assert out == alone
    assert out[1] is IndexError
    assert all(isinstance(out[i], list) for i in (0, 2))
    assert st["prefill_rows"] == 2
    assert live == warm and len(live) == 2
