"""The paged decode step's CUDA graphs (``TransformerLM.paged_decode_step``).

On the CPU the capture is a fake, injected in place of ``_record``: it
runs the step's Python once, as a capture does, and its replay runs the
step again with the host counts put back, as a graph's replay runs no
Python.  The CPU kernels count no launch, so the wrappers the step calls
are spied on to count as the card's do.  These tests hold the
dispatcher's bookkeeping (the paged kernel's table forced to ``fused``,
whose wrapper is spied on): a key's first call eager, its second captured,
the later ones replayed; one graph a key, and no more than
``_GRAPH_KEYS`` keys kept; each replay advancing every host count by
what its capture counted; the counters in ``EngineStats.as_dict()``; a
capture that runs out of memory retried once and else left eager; and
its results equal to the eager step's bit for bit.  The card's case
(marked ``cuda``, skipped here) captures for real: the replayed step's
logits and pools equal the eager step's bit for bit at three keys, and
the kernels the profiler sees run are those the launch counts
credit.  No JAX here.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.deepseek_v2 import CONFIG as DSV2  # noqa: E402
from repro_torch.configs.deepseek_v2 import smoke_config  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.engine.models import mla as MLA  # noqa: E402
from repro_torch.kernels.latent_decode_attention import (  # noqa: E402
    ops as ld_ops)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    ops as pd_ops)

from _torch_paged_helpers import paged_variant  # noqa: E402,F401

PAGE = 4
F32 = dict(dtype="float32", param_dtype="float32")
CONFIGS = {"gqa": lambda: get_smoke("qwen3-1.7b").replace(**F32),
           "mla": lambda: smoke_config().replace(**F32)}


def _model(arch, device="cpu", cfg=None):
    cfg = cfg or CONFIGS[arch]()
    model = build_model(cfg.replace(attention_impl="cuda"), device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    return model.init(gen)


def _pools(model, n_pages, device="cpu", seed=5):
    """A float32 pool of ``n_pages`` pages (and None for V under latent
    attention), drawn from ``seed``."""
    layers, heads, width = model.paged_kv_layout()
    shape = (layers, n_pages, PAGE) + ((width,) if heads is None
                                       else (heads, width))
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn(shape, generator=g, device=device)
    v = None if heads is None else torch.randn(shape, generator=g,
                                               device=device)
    return k, v


def _inputs(B, n_pages, step, device="cpu"):
    """A step's tokens, page table and lengths: row b owns pages b *
    n_pages onwards, its length grows by one a step, the last row is
    padding."""
    pt = torch.arange(B * n_pages, dtype=torch.int32,
                      device=device).view(B, n_pages)
    lens = (torch.arange(B, dtype=torch.int32, device=device) * 3 + 2
            + step) % (n_pages * PAGE - 4)
    lens[-1] = -1
    tok = (torch.arange(B, dtype=torch.int32, device=device) * 7 + step) % 50
    return tok, pt, lens.contiguous()


class FakeCapture:
    """Stands in for ``_record``: the capture runs the step's Python once
    (the counts move, as under a real capture); the replay runs it again
    and takes back what that moved, as a graph's replay moves nothing."""

    def __init__(self, model):
        self.model, self.captured = model, 0

    def __call__(self, step):
        self.captured += 1
        step()
        model = self.model

        def replay():
            before = model._host_counts()
            step()
            model._add_host_counts({k: before[k] - n for k, n in
                                    model._host_counts().items()})
        return replay


@pytest.fixture(autouse=True)
def _fused(paged_variant):
    """The GQA step's variant, which the launch spies count."""
    paged_variant("fused")


@pytest.fixture
def launches(monkeypatch):
    """Count the CPU kernels' calls as launches, as the card's wrappers
    count theirs."""
    fused = pd_ops.fused_paged_decode_attention
    latent = ld_ops.latent_decode_attention

    def fused_spy(*a, **kw):
        pd_ops._count(False, "fused")
        return fused(*a, **kw)

    def latent_spy(*a, **kw):
        ld_ops._count()
        return latent(*a, **kw)

    monkeypatch.setattr(pd_ops, "fused_paged_decode_attention", fused_spy)
    monkeypatch.setattr(ld_ops, "latent_decode_attention", latent_spy)


def _graphed(model, monkeypatch):
    fake = FakeCapture(model)
    monkeypatch.setattr(model, "_graphs_apply", lambda token, impl: True)
    monkeypatch.setattr(model, "_record", fake)
    return fake


def _step(model, pools, inputs, eager=False):
    tok, pt, lens = inputs
    fn = model._paged_decode_step_eager if eager else model.paged_decode_step
    return fn(tok, pools[0], pools[1], pt, lens)


def _host(model):
    """The host counts a step moves."""
    return model._host_counts()


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_a_keys_first_call_is_eager_its_second_captures_the_rest_replay(
        arch, monkeypatch, launches):
    model = _model(arch)
    fake = _graphed(model, monkeypatch)
    pools = _pools(model, 48)
    seen = []
    for step in range(5):
        _step(model, pools, _inputs(4, 6, step))
        seen.append((fake.captured, model.decode_graph_captures,
                     model.decode_graph_replays, len(model._graphs)))
    assert seen == [(0, 0, 0, 0), (1, 1, 0, 1), (1, 1, 1, 1), (1, 1, 2, 1),
                    (1, 1, 3, 1)]
    assert model.counters()["decode_graph_capture_s"] > 0


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_one_graph_a_key(arch, monkeypatch, launches):
    """Batch, table width and pool each make a key of their own; the
    graphs of one batch size share one logits buffer."""
    model = _model(arch)
    fake = _graphed(model, monkeypatch)
    pools = _pools(model, 48)
    other = tuple(None if p is None else p.clone() for p in pools)
    keys = [(pools, 4, 6), (pools, 4, 9), (pools, 2, 6), (other, 4, 6)]
    out = {}
    for step in range(3):
        for i, (p, B, n) in enumerate(keys):
            out[i] = _step(model, p, _inputs(B, n, step))[0]
    assert fake.captured == len(model._graphs) == len(keys)
    assert model.decode_graph_replays == len(keys)
    assert out[0] is out[1] is out[3] and out[2] is not out[0]
    assert sorted(model._graph_logits) == [2, 4]
    _step(model, pools, _inputs(4, 6, 0), eager=True)
    _step(model, pools, _inputs(4, 7, 0))
    assert len(model._graphs) == len(keys)      # a new key: eager first
    model.float()                               # moved weights: none kept
    assert not model._graphs and not model._graph_logits


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_replays_advance_every_host_count_by_the_captured_steps(
        arch, monkeypatch, launches):
    model = _model(arch)
    _graphed(model, monkeypatch)
    pools = _pools(model, 48)
    moves = []
    for step in range(5):
        before = _host(model)
        global_before = (pd_ops.launches, pd_ops.variant_launches["fused"],
                         ld_ops.launches)
        _step(model, pools, _inputs(4, 6, step))
        after = _host(model)
        moves.append({k: n - before[k] for k, n in after.items()})
        assert (pd_ops.launches - global_before[0],
                pd_ops.variant_launches["fused"] - global_before[1],
                ld_ops.launches - global_before[2]) == (
            moves[-1]["paged.launches"], moves[-1]["paged.fused"],
            moves[-1].get("latent.launches", 0))
    # eager, capture and three replays: each step moves the same counts
    assert all(m == moves[0] for m in moves), moves
    n = model.cfg.num_layers
    if arch == "mla":
        assert moves[0]["latent.launches"] == n
        assert moves[0]["moe_layer_calls"] == \
            n - model.cfg.moe.first_dense_layers
        assert moves[0]["paged.launches"] == 0
    else:
        assert moves[0]["paged.launches"] == moves[0]["paged.fused"] == n


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_the_keys_used_last_are_kept_and_the_rest_dropped(
        arch, monkeypatch, launches):
    """Tables that grow a page a step, as long requests' do: each width
    is captured at its second call and replayed after, but a model keeps
    only its ``_GRAPH_KEYS`` widths used last, graphs and calls alike; a
    dropped width starts over, eager first; a width seen once amid more
    new ones than that is never captured."""
    model = _model(arch)
    fake = _graphed(model, monkeypatch)
    model._GRAPH_KEYS = keep = 3
    pools = _pools(model, 200)
    widths = range(4, 12)
    for n in widths:
        for step in range(3):                  # eager, captured, replayed
            _step(model, pools, _inputs(2, n, step))
        assert len(model._graphs) <= keep and not model._graph_calls
    assert [k[1] for k in model._graphs] == list(widths)[-keep:]
    assert fake.captured == model.decode_graph_captures == len(widths)
    assert model.decode_graph_replays == len(widths)
    _step(model, pools, _inputs(2, 9, 0))      # kept: replayed, now last
    assert model.decode_graph_replays == len(widths) + 1
    assert [k[1] for k in model._graphs] == [10, 11, 9]
    for n in (4, 4):                           # dropped: eager, captured
        _step(model, pools, _inputs(2, n, 0))
    assert fake.captured == len(widths) + 1
    assert [k[1] for k in model._graphs] == [11, 9, 4]
    for n in list(range(20, 20 + keep + 1)) + [20]:
        _step(model, pools, _inputs(2, n, 0))  # 20's first call forgotten
    assert fake.captured == len(widths) + 1
    assert len(model._graph_calls) == keep
    assert [k[1] for k in model._graphs] == [11, 9, 4]


@pytest.mark.parametrize("fails", [1, 2])
def test_a_capture_out_of_memory_runs_again_then_stays_eager(
        fails, monkeypatch, launches):
    """A capture that runs out of memory counts nothing of its partial
    step; the cache is emptied and it runs once more; where that fails
    too the key stays eager and is not captured again."""
    model = _model("mla")
    fake, attempts, emptied = FakeCapture(model), [], []

    def record(step):
        attempts.append(1)
        if len(attempts) <= fails:
            step()                      # part of the capture ran
            raise torch.OutOfMemoryError("no room for the graph")
        return fake(step)

    monkeypatch.setattr(model, "_graphs_apply", lambda token, impl: True)
    monkeypatch.setattr(model, "_record", record)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    # no graph holds the pool the aborted capture took: the next takes a
    # new one
    model._graph_pool = "the aborted capture's"
    pools = _pools(model, 48)
    moves = []
    for step in range(5):
        before = _host(model)
        _step(model, pools, _inputs(4, 6, step))
        moves.append({k: n - before[k] for k, n in _host(model).items()})
    assert all(m == moves[0] for m in moves), moves
    assert len(attempts) == 2 and emptied == [1]
    assert model._graph_pool is None
    captured = fails == 1
    assert len(model._graphs) == model.decode_graph_captures == captured
    assert model.decode_graph_replays == (3 if captured else 0)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_the_graph_counters_reach_the_engines_stats(arch):
    cfg = CONFIGS[arch]()
    eng = InferenceEngine(cfg, seed=0, page_size=PAGE, max_seq_len=64,
                          device="cpu")
    eng.load()
    try:
        eng.generate([list(range(5, 14))], max_new_tokens=3)
        d = eng.stats.as_dict()
    finally:
        eng.shutdown()
    for key in ("decode_graph_replays", "decode_graph_captures",
                "decode_graph_capture_s"):
        assert d[key] == 0, key              # the CPU step runs eager


@pytest.mark.parametrize("graphed", [False, True],
                         ids=["cpu_path", "fake_capture"])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_the_dispatcher_equals_the_eager_step_bit_for_bit(
        arch, graphed, monkeypatch):
    """Over two copies of one pool, step by step: the same logits and
    the same pools.  Unfaked, the CPU never captures."""
    model = _model(arch)
    if graphed:
        _graphed(model, monkeypatch)
    else:
        def refuse(step):
            raise AssertionError("captured on the CPU")
        monkeypatch.setattr(model, "_record", refuse)
    pools = _pools(model, 48)
    copy = tuple(None if p is None else p.clone() for p in pools)
    for step in range(4):
        for B, n in ((4, 6), (2, 9)):
            got = _step(model, pools, _inputs(B, n, step))[0]
            want = _step(model, copy, _inputs(B, n, step), eager=True)[0]
            assert torch.equal(got, want), (step, B, n)
    for a, b in zip(pools, copy):
        assert (a is None and b is None) or torch.equal(a, b)
    assert model.decode_graph_replays == (4 if graphed else 0)


# ------------------------------------------------------------ on the card
CARD = {
    "gqa": lambda: get_smoke("qwen3-1.7b"),
    "moe": lambda: get_smoke("deepseek-moe-16b"),
    "mla": lambda: DSV2.replace(num_layers=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CARD))
def test_the_replayed_step_equals_the_eager_step_on_the_card(arch):
    """A small GQA model (bf16), a small MoE model and DeepSeek-V2 at
    full width cut to 2 layers (a dense layer, then the held share of the
    experts): three calls at each of three keys, eager, captured and
    replayed, against the eager step over a copy of the pool; the logits,
    the pools and the launches a step equal, bit for bit.  The profiler
    sees the card run as many of the attention kernel as the launch
    counts credit, replays included: one a layer a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from torch.profiler import ProfilerActivity, profile
    dev = "cuda"
    cfg = CARD[arch]()
    model = _model(arch, dev, cfg)
    pools = _pools(model, 200, dev)
    copy = tuple(None if p is None else p.clone() for p in pools)
    keys = ((8, 8), (8, 12), (4, 8))
    kernel, counted = (("latent_decode_kernel", "latent.launches")
                       if arch == "mla" else
                       ("paged_split_kernel", "paged.launches"))
    credited = _host(model)[counted]
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for B, n in keys:
            for step in range(3):
                inputs = _inputs(B, n, step, dev)
                before = _host(model)
                got = _step(model, pools, inputs)[0].clone()
                moved = {k: v - before[k] for k, v in _host(model).items()}
                before = _host(model)
                want = _step(model, copy, inputs, eager=True)[0]
                eager = {k: v - before[k] for k, v in _host(model).items()}
                assert torch.equal(got, want), (arch, B, n, step)
                assert moved == eager, (arch, B, n, step)
                assert sum(eager.values()) > 0
        torch.cuda.synchronize()
    ran = sum(e.device_type() == torch.autograd.DeviceType.CUDA
              and kernel in e.name()
              for e in prof.profiler.kineto_results.events())
    credited = _host(model)[counted] - credited
    assert ran == credited == 2 * len(keys) * 3 * model.cfg.num_layers, \
        (ran, credited)
    for a, b in zip(pools, copy):
        assert (a is None and b is None) or torch.equal(a, b)
    assert model.decode_graph_captures == len(keys)
    assert model.decode_graph_replays == len(keys)
    if arch == "mla":
        assert isinstance(model, MLA.MLATransformerLM)
