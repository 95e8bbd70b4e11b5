"""The port's InferenceEngine against the JAX engine, on the CPU.

Both engines serve ``get_smoke("qwen3-1.7b")`` in float32 with the same
weights (the JAX init, bridged).  At temperature 0 the port must emit the
JAX engine's tokens exactly, through fresh prompts, warm re-runs that
alias a donor's partial page (copy-on-write), coalesced duplicates and a
request admitted mid-decode, with the same sharing counters, both on the
paged decode path and on the dense-view arm (``paged_decode=False``).
The hybrid ``get_smoke("recurrentgemma-2b")`` is served through the
dense-row path alike.  Sampled (temperature > 0) tokens differ from JAX's
by design (torch generators, not threefry), so only their determinism is
checked.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.sampling import sample  # noqa: E402

from _torch_paged_helpers import paged_variant  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PREFIX = list(range(10, 20))            # 10 tokens: a full page + 2
PROMPTS = [PREFIX + [100], PREFIX + [101], list(range(40, 47)),
           PREFIX + [100]]              # the last one is a duplicate
LONG, SHORT = list(range(60, 69)), [5, 6, 7, 8, 9]
STATS = ("prefix_hits", "tokens_reused", "pages_shared",
         "coalesced_requests", "prefill_tokens", "prefill_tokens_saved")


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


def _scenario(eng):
    """Fresh batch, warm re-run, then a request admitted mid-decode."""
    out = {"fresh": eng.generate(PROMPTS, max_new_tokens=5)}
    out["warm"] = eng.generate(PROMPTS, max_new_tokens=5)
    out["stats"] = {k: getattr(eng.stats, k) for k in STATS}
    n0 = eng.stats.decode_tokens
    h1 = eng.submit(LONG, max_new_tokens=24)
    _wait(lambda: eng.stats.decode_tokens > n0)
    h2 = eng.submit(SHORT, max_new_tokens=4)
    out["mid"] = (h1.result(), h2.result())
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke("qwen3-1.7b").replace(dtype="float32")
    eng = JaxEngine(jcfg, seed=0)
    eng.load()
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    return eng, cfg, params_from_jax(jax.tree.map(np.asarray, eng.params),
                                     cfg)


@pytest.fixture(scope="module")
def jax_run(weights):
    eng = weights[0]
    try:
        return _scenario(eng)
    finally:
        eng.shutdown()


def _torch_engine(weights, **kw):
    eng = InferenceEngine(weights[1], seed=0, device="cpu", **kw)
    eng.load(weights[2])
    return eng


def test_greedy_tokens_and_sharing_counters_equal_jax(weights, jax_run):
    eng = _torch_engine(weights)
    try:
        out = _scenario(eng)
        assert out["fresh"] == jax_run["fresh"]
        assert out["warm"] == jax_run["warm"] == out["fresh"]
        assert out["fresh"][0] == out["fresh"][3]            # duplicate
        assert out["stats"] == jax_run["stats"]
        assert out["stats"]["coalesced_requests"] >= 2
        assert out["stats"]["tokens_reused"] >= len(PREFIX)
        assert out["mid"] == jax_run["mid"]
        assert eng.stats.peak_batch >= 2
        assert eng.stats.view_rebuilds == 0
        eng.release_warm()
        assert eng.kv.pages_in_use == 0 and not eng.kv.sequences
    finally:
        eng.shutdown()


@pytest.mark.parametrize("variant", ["single", "blocked", "fused"])
def test_kernel_variants_give_identical_tokens(weights, jax_run,
                                               paged_variant, variant):
    """Each variant the paged kernel's table may name gives the JAX
    engine's tokens, fresh and warm."""
    paged_variant(variant)
    eng = _torch_engine(weights)
    try:
        out = (eng.generate(PROMPTS, max_new_tokens=5),
               eng.generate(PROMPTS, max_new_tokens=5))
    finally:
        eng.shutdown()
    assert out == (jax_run["fresh"], jax_run["warm"])


def test_widest_decode_table_follows_the_longest_row(weights):
    """The engine records the widest page table its paged decode built:
    the longest row's prompt and decode budget, in ``_T_QUANTUM`` keys;
    the dense view builds none."""
    eng = _torch_engine(weights)
    try:
        eng.generate([LONG, SHORT], max_new_tokens=5)
        assert eng.stats.widest_decode_table * eng.page_size == \
            eng._round_t(len(LONG) + 5) == 32
        eng.generate([list(range(1, 41))], max_new_tokens=4)
        assert eng.stats.widest_decode_table * eng.page_size == 64
        eng.generate([SHORT], max_new_tokens=3)
        assert eng.stats.widest_decode_table * eng.page_size == 64
    finally:
        eng.shutdown()
    dense = _torch_engine(weights, paged_decode=False)
    try:
        dense.generate([LONG], max_new_tokens=5)
        assert dense.stats.widest_decode_table == 0
    finally:
        dense.shutdown()


def test_unload_drops_weights_and_pages_and_reload_serves_alike(weights,
                                                                jax_run):
    eng = _torch_engine(weights)
    try:
        eng.generate(PROMPTS[:1], max_new_tokens=5)
        eng.unload()
        assert not eng.loaded and eng.kv is None
        assert eng.model.embed.device.type == "meta"
        eng.load(weights[2])
        assert eng.generate(PROMPTS[:1], max_new_tokens=5) == \
            jax_run["fresh"][:1]
        assert eng.stats.model_loads == 2
    finally:
        eng.shutdown()


def test_prefix_migrates_from_the_jax_engine(weights, jax_run):
    """KV exported by the JAX engine (f32 numpy wire format) is imported
    as a warm donor; the next prompt sharing it gets a prefix hit and the
    same tokens as a cold run."""
    jeng = JaxEngine(jax_smoke("qwen3-1.7b").replace(dtype="float32"),
                     seed=0)
    jeng.params = weights[0].params
    try:
        jeng.generate([PREFIX + [100]], max_new_tokens=2)
        toks, k, v = jeng.export_prefix(PREFIX + [101])
    finally:
        jeng.shutdown()
    eng = _torch_engine(weights)
    try:
        assert eng.import_prefix(toks, k, v) == 2
        assert eng.probe_prefix(PREFIX + [101]) == len(PREFIX)
        out = eng.generate([PREFIX + [101]], max_new_tokens=5)
        assert eng.stats.prefix_hits == 1
        assert out[0] == jax_run["fresh"][1]
    finally:
        eng.shutdown()


def test_grace_window_forms_one_wave_and_priority_jumps(weights, jax_run):
    """With a grace window, staggered submissions form one admission wave;
    with max_batch=1 a later interactive request is admitted before an
    earlier batch-lane one.  Tokens are unchanged either way."""
    eng = _torch_engine(weights, admission_window=0.05)
    try:
        handles = []
        for p in PROMPTS[:3]:
            handles.append(eng.submit(p, max_new_tokens=5))
            time.sleep(0.01)
        assert [h.result() for h in handles] == jax_run["fresh"][:3]
        assert eng.stats.admission_waves == 1
        assert eng.stats.peak_batch == 3
    finally:
        eng.shutdown()
    eng = _torch_engine(weights, max_batch=1)
    try:
        h0 = eng.submit(LONG, max_new_tokens=24)
        _wait(lambda: eng.stats.decode_tokens >= 1)
        h1 = eng.submit(PROMPTS[0], max_new_tokens=5)
        h2 = eng.submit(PROMPTS[2], max_new_tokens=5, priority=1)
        done = []
        h1.add_done_callback(lambda h: done.append(1))
        h2.add_done_callback(lambda h: done.append(2))
        h0.result()
        assert (h1.result(), h2.result()) == (jax_run["fresh"][0],
                                              jax_run["fresh"][2])
        assert done == [2, 1] and eng.stats.priority_jumps == 1
    finally:
        eng.shutdown()


def test_sample_masks_the_vocab_tail_and_top_k():
    logits = torch.zeros((2, 8))
    logits[:, 6:] = 5.0                      # the padded tail
    logits[0, 2], logits[1, 4] = 1.0, 2.0
    greedy = sample(logits, None, vocab_size=6)
    assert greedy.tolist() == [2, 4] and greedy.dtype == torch.int32
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):                       # top-1 is greedy at any temp
        assert sample(logits, gen, temperature=2.0, top_k=1,
                      vocab_size=6).tolist() == [2, 4]


def test_sampling_is_deterministic_per_request(weights):
    outs = []
    for _ in range(2):
        eng = _torch_engine(weights)
        try:
            outs.append(eng.generate(PROMPTS, max_new_tokens=6,
                                     temperature=0.8))
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]
    assert outs[0][0] == outs[0][3]          # duplicates coalesce
    assert all(0 <= t < 256 for row in outs[0] for t in row)


# ------------------------------------------------- dense view (qwen3 A/B)

@pytest.fixture(scope="module")
def jax_dense_run(weights):
    eng = JaxEngine(jax_smoke("qwen3-1.7b").replace(dtype="float32"),
                    seed=0, paged_decode=False)
    eng.params = weights[0].params
    try:
        return _scenario(eng)
    finally:
        eng.shutdown()


def test_dense_view_arm_gives_the_paged_and_the_jax_tokens(weights,
                                                           jax_run,
                                                           jax_dense_run):
    eng = _torch_engine(weights, paged_decode=False)
    try:
        out = _scenario(eng)
        assert out["fresh"] == jax_dense_run["fresh"] == jax_run["fresh"]
        assert out["warm"] == jax_dense_run["warm"]
        assert out["mid"] == jax_dense_run["mid"] == jax_run["mid"]
        assert out["stats"] == jax_dense_run["stats"]
        assert eng.stats.view_rebuilds >= 2
        eng.release_warm()
        assert eng.kv.pages_in_use == 0
    finally:
        eng.shutdown()


# ------------------------------------------------- dense rows (hybrid)

# prompt lengths at or under the smoke window (16) or a multiple of it,
# where the JAX reference places its ring correctly
HYB_PROMPTS = [list(range(10, 26)), list(range(40, 45)),
               list(range(60, 92)), list(range(10, 26))]
HYB_LATE = list(range(100, 109))


def _hybrid_scenario(eng):
    handles = [eng.submit(p, max_new_tokens=6) for p in HYB_PROMPTS]
    _wait(lambda: eng.stats.decode_tokens >= 1)
    handles.append(eng.submit(HYB_LATE, max_new_tokens=5))
    return ([h.result() for h in handles],
            eng.stats.coalesced_requests, eng.kv)


@pytest.fixture(scope="module")
def hybrid_weights():
    jcfg = jax_smoke("recurrentgemma-2b").replace(dtype="float32")
    eng = JaxEngine(jcfg, seed=0)
    eng.load()
    cfg = get_smoke("recurrentgemma-2b").replace(dtype="float32")
    return eng, cfg, params_from_jax(jax.tree.map(np.asarray, eng.params),
                                     cfg)


def test_hybrid_dense_rows_give_the_jax_tokens(hybrid_weights):
    jeng, cfg, sd = hybrid_weights
    try:
        j_out, j_coalesced, j_kv = _hybrid_scenario(jeng)
    finally:
        jeng.shutdown()
    eng = InferenceEngine(cfg, seed=0, device="cpu")
    eng.load(sd)
    try:
        out, coalesced, kv = _hybrid_scenario(eng)
        assert out == j_out
        assert out[0] == out[3]                    # the duplicate
        assert coalesced == j_coalesced == 1
        assert kv is None and j_kv is None         # no pages on this path
        assert eng.stats.view_rebuilds >= 2
        assert eng.probe_prefix(HYB_PROMPTS[0]) == 0
        assert eng.export_prefix(HYB_PROMPTS[0]) is None
        assert eng.import_prefix(HYB_PROMPTS[0], None, None) == 0
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.submit(list(range(500)), max_new_tokens=16)
        eng.unload()
        assert eng._view is None and not eng.loaded
    finally:
        eng.shutdown()
