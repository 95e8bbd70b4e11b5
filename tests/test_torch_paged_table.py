"""The paged kernel's per-shape variant table on the port.

``kernel_config`` against the JAX package's resolution rules, case by
case as ``tests/test_kernel_bench.py`` holds JAX's, a table at another
path standing in for JAX's environment override, and no environment
variable steering the port; the checked-in table (the sweep's output from the
card) against the configs' paged keys; ``paged_decode_step`` following the
table on the smoke qwen3 with weights bridged from the JAX init (on the
CPU the wrappers run their plain versions, so a variant changes no bit),
and the engine resolving it once;
the attend-only arms' append, which makes no host sync, against
``scatter_append_ref`` on the CPU and counted on meta; and the sweep,
which refuses to run or persist off the card.
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.kernels.paged_decode_attention import ops as jax_ops  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.kernels.paged_decode_attention import ops  # noqa: E402
from repro_torch.kernels.paged_decode_attention import tune  # noqa: E402
from repro_torch.kernels.paged_decode_attention.ref import (  # noqa: E402
    scatter_append_ref)
from repro_torch.launch.op_cost import analyze_ops  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_table():
    """No table cached across cases."""
    ops._load_table.cache_clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ops._load_table.cache_clear()


def _use(path, monkeypatch):
    """Put the table at ``path`` in the checked-in table's place."""
    monkeypatch.setattr(ops, "_DEFAULT_TABLE", str(path))
    ops._load_table.cache_clear()


def _write(tmp_path, table, monkeypatch):
    p = tmp_path / "table.json"
    p.write_text(json.dumps(table))
    _use(p, monkeypatch)
    return p


# ------------------------------------------------------------- resolution
@pytest.mark.parametrize("shape", [(64, 8, 128, 4), (8, 8, 128, 2),
                                   (8, 16, 128, 1), (16, 2, 16, 2),
                                   (32, 4, 64, 8)])
def test_shape_key_equals_jax(shape):
    assert ops.shape_key(*shape) == jax_ops.shape_key(*shape)


def test_kernel_config_default_and_exact_key():
    """An unknown shape takes the checked-in table's default; an exact key
    takes its own entry; neither carries a grid layout."""
    table = json.load(open(ops._DEFAULT_TABLE))["configs"]
    kc = ops.kernel_config(999, 999, 999, 999)          # no such key
    assert kc == {k: table["default"][k]
                  for k in ("variant", "pages_per_block")}
    assert kc["variant"] in ops.VARIANTS
    assert kc["pages_per_block"] in ops.PAGES_PER_BLOCK
    key = next(k for k in table if k != "default")
    ps, hkv, dh, g = map(int, re.findall(r"\d+", key))
    assert ops.kernel_config(ps, hkv, dh, g) == {
        k: table[key][k] for k in ("variant", "pages_per_block")}


def test_kernel_config_table_path_override(tmp_path, monkeypatch):
    """Another table in the checked-in one's place is read (JAX's
    REPRO_KERNEL_AUTOTUNE case); a JAX table's grid_layout is
    ignored."""
    _write(tmp_path, {"configs": {
        "default": {"variant": "blocked", "pages_per_block": 2,
                    "grid_layout": "hb"},
        "ps32-hkv4-dh64-g2": {"variant": "single", "pages_per_block": 1,
                              "grid_layout": "bh"}}}, monkeypatch)
    assert ops.kernel_config(7, 7, 7, 7) == {"variant": "blocked",
                                             "pages_per_block": 2}
    assert ops.kernel_config(32, 4, 64, 2) == {"variant": "single",
                                               "pages_per_block": 1}


@pytest.mark.parametrize("prefix", ["REPRO_", "REPRO_TORCH_"])
def test_kernel_config_environment_steers_nothing(monkeypatch, prefix):
    """A variant is forced only by passing it (JAX's REPRO_PAGED_VARIANT
    case is ``variant=``, below): neither package's environment names
    move the port's table."""
    want = ops.kernel_config(999, 1, 1, 1)
    monkeypatch.setenv(prefix + "PAGED_VARIANT", "blocked")
    monkeypatch.setenv(prefix + "KERNEL_AUTOTUNE", "/nonexistent.json")
    ops._load_table.cache_clear()
    assert ops.kernel_config(999, 1, 1, 1) == want == {
        k: json.load(open(ops._DEFAULT_TABLE))["configs"]["default"][k]
        for k in ("variant", "pages_per_block")}


def test_kernel_config_unreadable_table_falls_back(tmp_path, monkeypatch):
    _use(tmp_path / "missing.json", monkeypatch)
    assert ops.table() == {}
    assert ops.kernel_config(8, 8, 128, 2) == {
        "variant": ops.DEFAULT_VARIANT,
        "pages_per_block": ops.DEFAULT_PAGES_PER_BLOCK}
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    _use(bad, monkeypatch)
    assert ops.kernel_config(8, 8, 128, 2)["variant"] == "fused"


@pytest.mark.parametrize("entry,where", [
    ({"variant": "double", "pages_per_block": 2}, "default"),
    ({"variant": "blocked", "pages_per_block": 5}, "default"),
    ({"variant": "blocked", "pages_per_block": 0}, "default"),
    ({"variant": "fused", "pages_per_block": "4"}, "default"),
    ({"variant": "fused", "pages_per_block": True}, "default"),
    ({"variant": "paged"}, "ps8-hkv8-dh128-g2")])
def test_bad_entries_raise(tmp_path, monkeypatch, entry, where):
    _write(tmp_path, {"configs": {where: entry}}, monkeypatch)
    with pytest.raises(ValueError):
        ops.kernel_config(8, 8, 128, 2)


def test_checked_in_table_covers_every_paged_arch():
    """The table is the sweep's output from an NVIDIA card: its
    provenance names the card and power limit as nvidia-smi prints them,
    and it holds a valid entry for every paged arch's key (computed from
    the configs) and a default."""
    table = json.load(open(ops._DEFAULT_TABLE))
    prov = table["_provenance"]
    assert re.fullmatch(r"NVIDIA [^,]+, \d+(\.\d+)? W", prov["card"]), prov
    assert prov["command"].startswith(tune.COMMAND) \
        and "--persist" in prov["command"]
    for k in ("torch", "cuda", "date", "peaks"):
        assert prov[k], k
    keys = tune.paged_shapes()
    assert set(keys) == {"ps8-hkv8-dh128-g2", "ps8-hkv8-dh128-g3",
                         "ps8-hkv8-dh128-g4", "ps8-hkv8-dh128-g8",
                         "ps8-hkv16-dh128-g1"}
    assert keys["ps8-hkv8-dh128-g2"]["archs"] == ["qwen3-1.7b",
                                                  "internvl2-2b"]
    configs = table["configs"]
    assert set(keys) | {"default"} <= set(configs)
    for key, entry in configs.items():
        assert entry["variant"] in ops.VARIANTS, key
        assert entry["pages_per_block"] in ops.PAGES_PER_BLOCK, key
    for key, shape in keys.items():
        timed = table["sweep"][key]
        labels = [c["label"] for c in tune.candidates(
            shape["page_size"], shape["head_dim"])]
        assert list(timed) == labels, key
        assert configs[key] == tune.winner(timed), key
        for r in timed.values():
            assert len(r["ms"]) == len(tune.BATCHES) * len(tune.LENGTHS)
            assert r["score_ms"] == pytest.approx(sum(r["ms"].values()))


def test_candidates_dedupe_by_stage():
    """At the engine's f32 pools (ps 8, Dh 128) a stage holds at most two
    pages: four distinct kernels; a bf16 pool allows four."""
    assert [c["label"] for c in tune.candidates(8, 128)] == [
        "single", "blocked@2", "fused@1", "fused@2"]
    assert [(c["label"], c["stage"]) for c in tune.candidates(8, 128, 2)] \
        == [("single", 1), ("blocked@2", 2), ("blocked@3", 3),
            ("blocked@4", 4), ("fused@1", 1), ("fused@2", 2),
            ("fused@3", 3), ("fused@4", 4)]


def test_sweep_refuses_off_the_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "t.json"
    assert tune.main(["--persist", "--out", str(out)]) != 0
    assert not out.exists()
    assert tune.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


# ------------------------------------------------- the append, no host sync
def _layout(rng, B=5, NP=4, ps=4, P=24, Hkv=2, Dh=8):
    pt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    lens = rng.integers(0, NP * ps, size=(B,)).astype(np.int32)
    k = torch.from_numpy(rng.standard_normal((P, ps, Hkv, Dh)).astype(
        np.float32))
    new = torch.from_numpy(rng.standard_normal((B, Hkv, Dh)).astype(
        np.float32))
    return pt, lens, k, new


@pytest.mark.parametrize("case", ["mixed", "first_padded", "all_padded",
                                  "padding_aliases_a_live_slot"])
def test_append_equals_the_masked_scatter(case):
    """``append_rows_`` at ``append_targets`` writes what
    ``scatter_append_ref`` writes, bitwise, and nothing else: padding
    rows anywhere, none live, and a padding row whose (zeroed) table
    names the slot a live row writes."""
    rng = np.random.default_rng(3)
    pt, lens, k, new = _layout(rng)
    lens[[1, 3]] = -1
    if case == "first_padded":
        lens[0] = -1
    elif case == "all_padded":
        lens[:] = -1
    elif case == "padding_aliases_a_live_slot":
        lens[2] = 0
        pt[1] = pt[2]
    pt_t, lens_t = torch.from_numpy(pt), torch.from_numpy(lens)
    ref, _ = scatter_append_ref(k.clone(), k.clone(), pt_t, lens_t, new,
                                new)
    got = k.clone()
    ops.append_rows_(got, ops.append_targets(pt_t, lens_t, k.shape[1]), new)
    assert torch.equal(got, ref)
    if case == "all_padded":
        assert torch.equal(got, k)


def test_append_runs_on_meta_without_a_host_sync():
    def step(pool, pt, lens, new):
        ops.append_rows_(pool, ops.append_targets(pt, lens, 8), new)

    with pytest.raises(NotImplementedError):
        torch.nonzero(torch.empty(4, device="meta") > 0)
    r = analyze_ops(step, torch.empty(64, 8, 2, 16, device="meta"),
                    torch.empty(4, 3, dtype=torch.int32, device="meta"),
                    torch.empty(4, dtype=torch.int32, device="meta"),
                    torch.empty(4, 2, 16, device="meta"))
    assert r["flops"] == 0 and 0 < r["bytes"] < 64 * 8 * 2 * 16 * 4


# --------------------------------------------- the decode step on the table
@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_smoke("qwen3-1.7b").replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke("qwen3-1.7b").replace(dtype="float32")
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, tm


def _step_inputs(tm, seed=0):
    """A shuffled pool of random K/V, three live rows ending mid-page and
    a padding row."""
    rng = np.random.default_rng(seed)
    layers, hkv, dh = tm.paged_kv_layout()
    B, NP, ps, P = 4, 3, 8, 16
    pools = [rng.standard_normal((layers, P, ps, hkv, dh)).astype(np.float32)
             for _ in range(2)]
    pt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    lens = np.asarray([5, 17, 9, -1], np.int32)
    tok = rng.integers(1, tm.cfg.vocab_size, size=(B,)).astype(np.int32)
    return tok, pools, pt, lens


def _torch_step(tm, inputs, **kw):
    tok, pools, pt, lens = inputs
    kp, vp = (torch.from_numpy(p.copy()) for p in pools)
    lg, kp, vp = tm.paged_decode_step(
        torch.from_numpy(tok), kp, vp, torch.from_numpy(pt),
        torch.from_numpy(lens), **kw)
    return lg, kp, vp


def _recorders(monkeypatch):
    seen = []
    fused, attend = ops.fused_paged_decode_attention, \
        ops.paged_decode_attention

    def rec_fused(*a, pages_per_block=None, **kw):
        seen.append(("fused", pages_per_block))
        return fused(*a, pages_per_block=pages_per_block, **kw)

    def rec_attend(*a, variant=None, pages_per_block=None, **kw):
        seen.append((variant, pages_per_block))
        return attend(*a, variant=variant, pages_per_block=pages_per_block,
                      **kw)

    monkeypatch.setattr(ops, "fused_paged_decode_attention", rec_fused)
    monkeypatch.setattr(ops, "paged_decode_attention", rec_attend)
    return seen


@pytest.mark.parametrize("entry", [None, ("single", 1), ("blocked", 3),
                                   ("fused", 2)])
def test_decode_step_follows_the_table(bridged, tmp_path, monkeypatch,
                                       entry):
    """With no variant, ``impl="cuda"`` resolves the table at the smoke
    model's key (once a step when called directly) and hands its variant and pages a block to
    the wrapper every layer; the logits equal the JAX step's."""
    jm, jp, tm = bridged
    cfg = tm.cfg
    key = ops.shape_key(8, cfg.num_kv_heads, tm.head_dim,
                        cfg.num_heads // cfg.num_kv_heads)
    if entry is None:                   # the checked-in table
        want = ops.kernel_config(8, cfg.num_kv_heads, tm.head_dim,
                                 cfg.num_heads // cfg.num_kv_heads)
        want = (want["variant"], want["pages_per_block"])
    else:
        _write(tmp_path, {"configs": {
            "default": {"variant": "fused", "pages_per_block": 8},
            key: {"variant": entry[0], "pages_per_block": entry[1]}}},
            monkeypatch)
        want = entry
    calls = []
    real = ops.kernel_config

    def counted(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(ops, "kernel_config", counted)
    seen = _recorders(monkeypatch)
    inputs = _step_inputs(tm)
    lg, _, _ = _torch_step(tm, inputs, impl="cuda")
    assert len(calls) == 1
    assert seen == [want] * cfg.num_layers
    tok, pools, pt, lens = inputs
    jlg, _, _ = jm.paged_decode_step(
        jp, jnp.asarray(tok), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(pt), jnp.asarray(lens), impl="xla")
    np.testing.assert_allclose(lg[:3].numpy(), np.asarray(jlg)[:3],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ppb", [None, 3])
def test_explicit_variant_wins_over_the_table(bridged, tmp_path,
                                              monkeypatch, ppb):
    """An explicit variant runs at the caller's pages a block (None: the
    wrapper's default), and the table is not read."""
    jm, jp, tm = bridged
    _write(tmp_path, {"configs": {"default": {"variant": "single",
                                              "pages_per_block": 1}}},
           monkeypatch)
    monkeypatch.setattr(ops, "kernel_config", None)
    seen = _recorders(monkeypatch)
    _torch_step(tm, _step_inputs(tm), impl="cuda", variant="fused",
                pages_per_block=ppb)
    assert seen == [("fused", ppb)] * tm.cfg.num_layers


@pytest.mark.parametrize("variant", ["single", "blocked", "fused"])
def test_forced_variants_give_the_fused_steps_bits(bridged, monkeypatch,
                                                   variant):
    """Under every forced variant the step's logits and pools equal the
    fused step's bitwise, and the pages it did not write are untouched."""
    _, _, tm = bridged
    inputs = _step_inputs(tm, seed=1)
    ref = _torch_step(tm, inputs, impl="cuda", variant="fused")
    seen = _recorders(monkeypatch)
    got = _torch_step(tm, inputs, impl="cuda", variant=variant)
    assert {v for v, _ in seen} == {variant}
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    _, pools, pt, lens = inputs
    written = torch.zeros(got[1].shape, dtype=torch.bool)
    for b, n in enumerate(lens):
        if n >= 0:
            written[:, pt[b, n // 8], n % 8] = True
    assert torch.equal(got[1][~written], torch.from_numpy(pools[0])[~written])


@pytest.mark.parametrize("variant", ["single", "blocked", "fused"])
def test_decode_step_counts_on_meta_under_every_variant(variant):
    """The step as the dry run and ``[roofline.card]`` trace it: meta
    tensors, ``impl="cuda"``, each variant passed to the step (and the
    table's, with none); the attend-only arms' append adds bytes and no
    FLOPs."""
    cfg = get_smoke("qwen3-1.7b").replace(attention_impl="cuda")
    model = build_model(cfg, device="meta")
    layers, hkv, dh = model.paged_kv_layout()
    B, NP, ps = 4, 3, 8

    def meta(*s, dtype=torch.int32):
        return torch.empty(*s, dtype=dtype, device="meta")

    def count(v):
        pools = [meta(layers, B * NP, ps, hkv, dh, dtype=torch.float32)
                 for _ in range(2)]
        return analyze_ops(
            lambda *a: model.paged_decode_step(*a, variant=v), meta(B),
            *pools, meta(B, NP), meta(B))

    r, f = count(variant), count("fused")
    assert r["flops"] > 0 and r["bytes"] > 0
    if variant == "fused":
        assert r == f
    else:
        assert r["flops"] == f["flops"] and r["bytes"] > f["bytes"]
    if variant == model.paged_kernel(ps)["variant"]:
        assert count(None) == r


@pytest.mark.parametrize("pinned", [None, "blocked"])
def test_engine_resolves_the_table_once(bridged, tmp_path, monkeypatch,
                                        pinned):
    """The engine reads the table once, when it is built, and every
    decode step launches what it read: the table's variant and pages a
    block, or its ``kernel_variant`` at the table's pages a block; its
    greedy tokens equal a ``fused`` engine's."""
    _, _, tm = bridged
    cfg = tm.cfg
    key = ops.shape_key(8, cfg.num_kv_heads, tm.head_dim,
                        cfg.num_heads // cfg.num_kv_heads)
    _write(tmp_path, {"configs": {key: {"variant": "single",
                                        "pages_per_block": 3}}},
           monkeypatch)
    prompts = [[5, 6, 7, 8, 9], [11, 12, 13]]
    ref = InferenceEngine(cfg, seed=0, device="cpu", kernel_variant="fused")
    ref.load(tm.state_dict())
    try:
        want = ref.generate(prompts, max_new_tokens=3)
    finally:
        ref.shutdown()
    calls = []
    real = ops.kernel_config
    monkeypatch.setattr(ops, "kernel_config",
                        lambda *a: calls.append(a) or real(*a))
    eng = InferenceEngine(cfg, seed=0, device="cpu", kernel_variant=pinned)
    eng.load(tm.state_dict())
    assert len(calls) == 1
    seen = _recorders(monkeypatch)
    try:
        got = eng.generate(prompts, max_new_tokens=3)
    finally:
        eng.shutdown()
    assert len(calls) == 1 and seen
    assert set(seen) == {(pinned or "single", 3)}
    assert got == want
