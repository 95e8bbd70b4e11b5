"""The engine loop's spans and host counters, on the CPU.

``repro_torch.engine.spans`` keeps a count, a total and a self time for
each of a fixed set of span names; the engine opens them on its loop
thread only, around admission, the decode step and their parts, and
``EngineStats`` counts blocking host<->device copies, deferred
admissions, warm evictions and radix-tree rebuilds.  These tests serve
the qwen3 smoke config in float32 on ``device="cpu"`` and hold the
totals to their nesting, the counts to the work done (spies on the
counted call sites), the tokens to an engine whose recorder is stubbed
out, and the profiler's record of the spans to the loop thread's
``engine.step``.  No JAX here.
"""
import contextlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import EngineStats, InferenceEngine  # noqa: E402
from repro_torch.engine.kvcache import PagedKVCache  # noqa: E402
from repro_torch.engine.spans import SPAN_NAMES, SpanRecorder  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = get_smoke("qwen3-1.7b").replace(dtype="float32")
PREFIX = list(range(10, 20))            # 10 tokens: a full page + 2
PROMPTS = [PREFIX + [100], PREFIX + [101], list(range(40, 47)),
           PREFIX + [100]]              # the last one is a duplicate
LONG, SHORT = list(range(60, 69)), [5, 6, 7, 8, 9]

# each span's children, as the engine nests them
CHILDREN = {
    "engine.step": ("engine.admit", "engine.decode"),
    "engine.admit": (
        "engine.admit.pick", "engine.admit.request", "engine.admit.view",
        "engine.admit.model", "engine.admit.pool", "engine.admit.tree",
        "engine.admit.sync"),
    "engine.admit.request": (
        "engine.admit.seed", "engine.admit.match", "engine.admit.pages"),
    "engine.decode": (
        "engine.decode.tables", "engine.decode.model",
        "engine.decode.sample", "engine.decode.sync",
        "engine.decode.retire"),
}


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


def _engine(**kw):
    eng = InferenceEngine(CFG, seed=0, device="cpu", **kw)
    eng.load()
    return eng


def _scenario(eng):
    """A cold batch with a coalesced duplicate, a warm re-run over its
    donors, then a request admitted mid-decode; returns the tokens and
    the number of requests submitted."""
    out = [eng.generate(PROMPTS, max_new_tokens=5),
           eng.generate(PROMPTS, max_new_tokens=5)]
    n0 = eng.stats.decode_tokens
    h1 = eng.submit(LONG, max_new_tokens=24)
    _wait(lambda: eng.stats.decode_tokens > n0)
    h2 = eng.submit(SHORT, max_new_tokens=4, temperature=0.7)
    out.append((h1.result(), h2.result()))
    eng.drain()
    return out, 2 * len(PROMPTS) + 2


def _spy(monkeypatch, owner, name, calls):
    orig = getattr(owner, name)

    def spy(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return orig(*a, **kw)

    monkeypatch.setattr(owner, name, spy)


def _spans(eng):
    return {k: v for k, v in eng.stats.as_dict().items()
            if k.startswith("span")}


@pytest.fixture(scope="module")
def served():
    """One engine through the scenario, with every counted site spied
    on: the model's two entry points, the engine's uploads and reads, the
    pool's index uploads."""
    mp = pytest.MonkeyPatch()
    calls = {}
    eng = _engine()
    try:
        with mp.context() as m:
            for owner, name in ((InferenceEngine, "_tokens"),
                                (InferenceEngine, "_to_host"),
                                (InferenceEngine, "_cache_view"),
                                (PagedKVCache, "_index"),
                                (eng.model, "paged_decode_step"),
                                (eng.model, "prefill_with_cache")):
                _spy(m, owner, name, calls)
            tokens, submitted = _scenario(eng)
        yield eng, tokens, submitted, eng.stats.as_dict(), calls
    finally:
        eng.shutdown()


@pytest.mark.parametrize("parent", sorted(CHILDREN))
def test_a_parent_is_its_self_time_and_its_children(served, parent):
    stats = served[3]
    assert stats["span_n." + parent] > 0
    kids = sum(stats["span_s." + c] for c in CHILDREN[parent])
    assert stats["span_s." + parent] == pytest.approx(
        stats["span_self_s." + parent] + kids, abs=1e-6)
    assert 0.0 <= stats["span_self_s." + parent] <= stats["span_s." + parent]


def test_counts_match_the_work(served):
    eng, _, submitted, stats, calls = served
    assert stats["coalesced_requests"] >= 1 and stats["prefix_hits"] >= 1
    assert stats["span_n.engine.decode"] == calls["paged_decode_step"]
    assert stats["span_n.engine.admit.model"] == calls["prefill_with_cache"]
    assert stats["prefill_rows"] == submitted - stats["coalesced_requests"]
    assert stats["admit_deferrals"] == 0
    assert stats["span_n.engine.admit.request"] == stats["prefill_rows"]
    # one first-token read a prefill call, one read of the sampled ids a
    # step
    assert calls["_to_host"] == stats["span_n.engine.admit.sync"] \
        + stats["span_n.engine.decode.sync"]
    assert stats["host_syncs"] == sum(
        calls[k] for k in ("_tokens", "_to_host", "_cache_view", "_index"))
    # three uploads a step: tokens, page table, lengths
    assert calls["_tokens"] >= 3 * calls["paged_decode_step"]


def test_tokens_do_not_depend_on_the_recorder(served):
    eng = _engine()
    eng._span = lambda name, arg=None: contextlib.nullcontext()
    try:
        tokens, _ = _scenario(eng)
    finally:
        eng.shutdown()
    assert tokens == served[1]
    assert all(v == 0 for v in _spans(eng).values())


def test_a_small_pool_defers_evicts_and_rebuilds(monkeypatch):
    """16 pages of 8 hold two 34-token requests but not a third while
    both decode; one warm sequence kept, so the others are evicted, and
    the radix tree is rebuilt past 8 insertions."""
    calls = {}
    _spy(monkeypatch, PagedKVCache, "free_sequence", calls)
    rebuilt = []
    prune = InferenceEngine._maybe_prune_tree

    def spy_prune(self):
        before = self.warm_prefixes
        prune(self)
        rebuilt.append(self.warm_prefixes is not before)

    monkeypatch.setattr(InferenceEngine, "_maybe_prune_tree", spy_prune)
    eng = _engine(num_pages=16, max_batch=4, max_warm_sequences=1)
    _spy(monkeypatch, eng.model, "prefill_with_cache", calls)
    try:
        prompts = [[t + 20 * i for t in range(10)] for i in range(3)]
        eng.generate(prompts, max_new_tokens=24)
        eng.generate([[t + 20 * i for t in range(9)] for i in range(3, 11)],
                     max_new_tokens=2)
        eng.drain()
        st = eng.stats.as_dict()
    finally:
        eng.shutdown()
    assert st["admit_deferrals"] >= 1
    assert st["span_n.engine.admit.request"] == \
        st["prefill_rows"] + st["admit_deferrals"]
    assert st["prefill_rows"] == 11
    assert st["span_n.engine.admit.model"] == calls["prefill_with_cache"]
    # every retired sequence but the one left warm was evicted
    assert st["warm_evictions"] == calls["free_sequence"] == 10
    assert st["tree_rebuilds"] == sum(rebuilt) >= 1


def test_an_unknown_span_name_raises():
    with pytest.raises(KeyError):
        SpanRecorder().span("engine.nope")


def test_other_threads_record_nothing(served):
    eng = served[0]
    before = _spans(eng)
    syncs = eng.stats.host_syncs
    got = {}

    def caller():
        got["probe"] = eng.probe_prefix(PROMPTS[0])
        got["export"] = eng.export_prefix(PROMPTS[0])

    t = threading.Thread(target=caller)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert got["probe"] >= 4 and got["export"] is not None
    assert _spans(eng) == before
    # the export's index upload and its two reads of K and V
    assert eng.stats.host_syncs == syncs + 3


def test_the_key_set_is_fixed_at_construction(served):
    # the model's own counters (its decode graphs') are part of the set
    stats = served[3]
    fresh = EngineStats(probes=served[0].model.counters).as_dict()
    assert list(stats) == list(fresh)
    assert set(served[0].model.counters()) < set(fresh)
    assert all(isinstance(v, (int, float)) for v in fresh.values())
    spans = [k for k in fresh if k.startswith("span")]
    assert sorted(spans) == sorted(f"{kind}.{n}" for n in SPAN_NAMES
                                   for kind in ("span_s", "span_self_s",
                                                "span_n"))
    assert "load_seconds" not in fresh


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    orig = torch.profiler.record_function

    def spy(*a, **kw):
        entered.append(a)
        return orig(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    eng = _engine()
    try:
        eng.generate(PROMPTS, max_new_tokens=3)
    finally:
        eng.shutdown()
    assert eng.stats.spans.count["engine.decode"] > 0
    assert entered == []


def _all_threads_config():
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        pytest.skip("this torch's profiler has no profile_all_threads, so "
                    "it records no CPU event of the engine's loop thread")


def test_the_profiler_sees_the_loop_threads_spans():
    config = _all_threads_config()
    eng = _engine()
    try:
        eng.generate(PROMPTS, max_new_tokens=3)     # the loop thread runs
        n0 = dict(eng.stats.spans.count)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=config) as prof:
            eng.generate([PREFIX + [7], list(range(70, 80))],
                         max_new_tokens=4)
            eng.drain()                 # the last step's spans have closed
        n1 = dict(eng.stats.spans.count)
    finally:
        eng.shutdown()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.start_thread_id())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("engine.")]
    steps = [e for e in events if e[0] == "engine.step"]
    assert steps
    names = {e[0] for e in events}
    for name in ("engine.admit.request", "engine.admit.model",
                 "engine.decode", "engine.decode.model",
                 "engine.decode.sync"):
        assert name in names
        # every span that closed while the profiler ran is in its record
        assert sum(e[0] == name for e in events) == n1[name] - n0[name]
    for name, s, e, tid in events:
        if name in ("engine.step", "engine.idle"):
            continue
        assert any(s0 <= s and e <= e0 and t0 == tid
                   for _, s0, e0, t0 in steps), name
