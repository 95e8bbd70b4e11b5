"""Architectures found by name (``archs/<arch>.py``): the two checked-in
configurations resolve to ``gqa``, which gives the numbers and the
reference bits the harness had before it delegated; an architecture
defined only under a fixture root is found and used by set-up, the
check, the pool's size and the mfu reader, with no edit of the harness;
the tracer reads its arguments by name."""
import contextlib
import copy
import hashlib
import io
import json
import pathlib
import types

import pytest
import torch

from portbench import archs
from portbench.harness import cell, driver, tracing
from portbench.harness.spec import Bench
from portbench.harness.tracing import DecodeCall, PrefillCall, Trace, Tracer
from portbench.reference import weights as W
from portbench.reference.model import served_logits
from portbench.tests.fixtures import DENSE, MOE, make_root
from portbench.yardstick import costs
from portbench.yardstick.peaks import PEAK_FLOPS_BF16

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
_GIB = 1 << 30

# the harness's numbers before it delegated to the architecture
# (commit 04b1e1f): weights' bytes, the f32 pool's bytes a token, the
# weights a token multiplies through, and the FLOPs of four tokens over
# 1, 5, 300 and 4096 keys
BEFORE = {
    "deepseek-67b-l32": (47_648_358_400, 262_144, 22_984_785_920,
                         188_494_118_912.0),
    "deepseek-moe-16b": (32_758_534_144, 458_752, 2_618_818_560,
                         21_960_261_632.0),
}
CONTEXTS = [1, 5, 300, 4096]
# the first 16 hex digits of the SHA-256 of the reference's float32
# bytes before it delegated (commit 04b1e1f; torch's CPU kernels, one
# intra-op thread), for _seqs() at seed 11
DIGESTS = {("dense", "float32"): "132863d95f892638",
           ("dense", "fp8"): "bbcd0180fdc5d4c4",
           ("moe", "float32"): "8785ba755ce82530",
           ("moe", "fp8"): "dfb01bfc8273f9a0"}

PROBE = '''"""An architecture only this root knows: gqa's model with every std
halved, its pool counted at three times gqa's, its FLOPs at twice, and
a served token's reference logit lowered by SHIFT.  Its reference is
gqa's, run while gqa's layout is this one."""
from portbench.archs import gqa

CALLS = []
SHIFT = 0.0
GQA_LAYOUT = gqa.layout


def layout(m):
    CALLS.append("layout")
    return {k: (s, dt, std / 2) for k, (s, dt, std) in GQA_LAYOUT(m).items()}


def served_logits(m, seed, seqs, *, device, prefill_quantum=16,
                  precision="float32"):
    CALLS.append("served_logits")
    gqa.layout = layout
    try:
        out = gqa.served_logits(m, seed, seqs, device=device,
                                prefill_quantum=prefill_quantum,
                                precision=precision)
    finally:
        gqa.layout = GQA_LAYOUT
    for o, (_, served) in zip(out, seqs):
        o[range(len(served)), list(served)] -= SHIFT
    return out


def kv_bytes_per_token(m):
    return 3 * gqa.kv_bytes_per_token(m)


def token_flops(m, contexts):
    return 2 * gqa.token_flops(m, contexts)
'''


def _config(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_checked_in_configurations_give_the_numbers_they_gave(name):
    m = _config(name)
    arch = Bench(ROOT).arch(archs.arch_name(m))
    assert archs.arch_name(m) == "gqa" and "arch" not in m
    pbytes, kv, params, flops = BEFORE[name]
    assert cell.param_bytes(m, arch) == pbytes
    assert arch.kv_bytes_per_token(m) == kv
    assert arch.matmul_params(m) == costs.matmul_params(m) == params
    assert arch.token_flops(m, CONTEXTS) == \
        costs.token_flops(m, CONTEXTS) == flops
    # the pool's pages as the harness counted them: the free bytes less
    # the weights and the reserve, over 2 x layers x page x Hkv x Dh x 4
    eng = {"page_size": 8, "activation_reserve_gb": 6}
    free = 84_460_000_000
    dh = m.get("head_dim") or m["d_model"] // m["num_heads"]
    page = 2 * m["num_layers"] * 8 * m["num_kv_heads"] * dh * 4
    assert cell.pool_pages(m, eng, free, arch) == \
        (free - pbytes - 6 * _GIB) // page
    assert cell.pool_pages(m, dict(eng, num_pages=7), None, arch) == 7


def _seqs():
    g = torch.Generator().manual_seed(7)
    return [(torch.randint(0, 250, (n,), generator=g).tolist(),
             torch.randint(0, 250, (k,), generator=g).tolist())
            for n, k in ((37, 5), (16, 9), (50, 3))]


@pytest.mark.parametrize("precision", ["float32", "fp8"])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_the_reference_gives_the_bits_it_gave(family, precision):
    m = {"dense": DENSE, "moe": MOE}[family]
    seqs = _seqs()
    out = Bench(ROOT).arch("gqa").served_logits(
        m, 11, seqs, device="cpu", prefill_quantum=16, precision=precision)
    digest = hashlib.sha256(b"".join(t.contiguous().numpy().tobytes()
                                     for t in out)).hexdigest()
    assert digest[:16] == DIGESTS[(family, precision)]
    again = served_logits(m, 11, seqs, device="cpu", prefill_quantum=16,
                          precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def _probe_root(tmp_path, arch="probe"):
    """The fixture root, with a configuration that names ``arch`` and a
    cell of it; ``archs/probe.py`` exists only under this root."""
    root = make_root(tmp_path)
    pb = root / "portbench"
    (pb / "archs").mkdir()
    (pb / "archs" / "probe.py").write_text(PROBE)
    conf = json.loads((pb / "configs" / "tiny-dense.json").read_text())
    conf["model"] = dict(conf["model"], arch=arch)
    (pb / "configs" / "tiny-probe.json").write_text(json.dumps(conf))
    (pb / "cells" / "probe.closed.json").write_text(
        (pb / "cells" / "dense.closed.json").read_text())
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-probe", "source": "test",
                           "file": "portbench/configs/tiny-probe.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "probe.closed", "config": "tiny-probe",
                             "traffic": "tiny_closed", "chips": 1,
                             "why": "test"})
    doc["end_to_end"][0]["workloads"].append("probe.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


def _served(bench, name, seed):
    """Set-up, the traffic's first six calls served whole, tear-down: a
    window's records whose tokens do not depend on timing."""
    with contextlib.redirect_stderr(io.StringIO()):
        s = cell.set_up(bench, name, seed, "cpu", warm=False)
        params = {k: p.detach().clone()
                  for k, p in s.engine.model.named_parameters()}
        calls = [s.traffic.call(i) for i in range(6)]
        handles = [s.engine.submit(c.prompt, max_new_tokens=c.max_new,
                                   temperature=0.0) for c in calls]
        recs = [driver.Record(c, due=0.0, done=1.0, tokens=h.result())
                for c, h in zip(calls, handles)]
        cell.tear_down(s)
    data = cell.RunData(s.cell, s.model, 1.0, 0.0,
                        driver.Window(recs, 0.0, 2.0, 2.0), {}, 8)
    return data, s, params


def test_an_architecture_in_new_files_alone(tmp_path):
    pytest.importorskip("repro_torch")
    bench = Bench(_probe_root(tmp_path))
    c = bench.cell("probe.closed")
    probe, gqa = c.arch, bench.arch("gqa")
    assert c.config["model"]["arch"] == "probe"
    assert probe.__file__ == str(tmp_path / "portbench" / "archs" /
                                 "probe.py")
    m, seed = c.config["model"], 2**31 + 5

    # set-up fills the port with the probe's layout (half gqa's std)
    data, s, params = _served(bench, "probe.closed", seed)
    lay = probe.layout(m)
    for key in ("embed", "blocks.1.attn.wk", "lm_head"):
        assert torch.equal(params[key], W.draw(lay[key], seed, key, "cpu"))
        assert not torch.equal(params[key],
                               W.draw(gqa.layout(m)[key], seed, key, "cpu"))

    # the check judges by the probe's reference: sound as it stands, and
    # every served token SHIFT below the best once the probe says so
    probe.CALLS.clear()
    checks = cell.judge(data, seed, s.device, s.engine_cfg)
    assert probe.CALLS == ["served_logits", "layout"]
    assert cell.correct(checks), checks
    probe.SHIFT = 7.0
    checks = cell.judge(data, seed, s.device, s.engine_cfg)
    assert not cell.correct(checks)
    assert checks["logit_gap"]["value"] > 6.0

    # the pool at the probe's bytes a token, given the free bytes
    eng = {"page_size": 8, "activation_reserve_gb": 0.001}
    free = 50 * _GIB
    left = free - cell.param_bytes(m, probe) - int(0.001 * _GIB)
    assert cell.pool_pages(m, eng, free, probe) == \
        left // (8 * 3 * gqa.kv_bytes_per_token(m))
    assert cell.param_bytes(m, probe) == cell.param_bytes(m, gqa)

    # mfu counts the probe's FLOPs
    trace = Trace(window_s=2.0, busy_s=1.0,
                  decode=[DecodeCall(1.0, [3, -1, 10])],
                  prefill=[PrefillCall(1.0, [0, 4], [5, 2])], kernel_s={})
    run = cell.RunData(c, m, 2.0, 0.0, None, {}, 8, trace)
    contexts = [4, 11, 1, 2, 3, 4, 5, 5, 6]
    assert bench.reader("mfu.batch")(run) == pytest.approx(
        100.0 * 2 * gqa.token_flops(m, contexts) / (2.0 * PEAK_FLOPS_BF16),
        rel=1e-12)


@pytest.mark.parametrize("arch,error", [("no_such_arch", FileNotFoundError),
                                        ("../gqa", ValueError),
                                        ("gqa py", ValueError)])
def test_a_bad_or_missing_architecture_raises(tmp_path, arch, error):
    bench = Bench(_probe_root(tmp_path, arch))
    with pytest.raises(error, match="archs"):
        bench.cell("probe.closed")
    if error is FileNotFoundError:
        with pytest.raises(FileNotFoundError, match=f"archs/{arch}.py"):
            Bench(ROOT).arch(arch)
    # the names kept from before serve gqa alone
    with pytest.raises(ValueError, match=f"archs/{arch}.py"):
        W.layout(dict(DENSE, arch=arch))
    with pytest.raises(ValueError, match=f"archs/{arch}.py"):
        costs.token_flops(dict(DENSE, arch=arch), [1])


class _Model:
    """Entry points that take the pool as one tensor, as a latent pool
    would, under the names the tracer binds."""

    def paged_decode_step(self, token, pool, page_table, lengths,
                          impl=None):
        return token + 1

    def prefill_with_cache(self, tokens, cache, impl=None, valid_len=None):
        return tokens.sum()

    def paged_cache_view(self, rows, lengths):
        return rows


class _Event:
    def record(self):
        pass


@pytest.mark.parametrize("by_keyword", [True, False])
def test_the_tracer_reads_arguments_by_name(monkeypatch, by_keyword):
    monkeypatch.setattr(tracing, "_events", lambda: (_Event(), _Event()))
    model = _Model()
    tracer = Tracer(types.SimpleNamespace(model=model, kv=None))
    tracer.active = True
    token, pool = torch.tensor([5, 6]), torch.zeros(2, 3)
    table, lengths = torch.zeros(2, 4, dtype=torch.int32), \
        torch.tensor([3, -1], dtype=torch.int32)
    tokens = torch.ones(2, 16, dtype=torch.long)
    cache = {"length": torch.tensor([0, 24])}
    if by_keyword:
        out = model.paged_decode_step(token=token, pool=pool, lengths=lengths,
                                      page_table=table)
        model.prefill_with_cache(tokens=tokens, cache=cache,
                                 valid_len=torch.tensor([16, 9]))
        model.prefill_with_cache(cache=cache, tokens=tokens[:1])
    else:
        out = model.paged_decode_step(token, pool, table, lengths, "torch")
        model.prefill_with_cache(tokens, cache, None, torch.tensor([16, 9]))
        model.prefill_with_cache(tokens[:1], cache)
    assert torch.equal(out, token + 1)
    assert [ln for _, ln in tracer._decode] == [[3, -1]]
    assert [(p, n) for _, p, n in tracer._prefill] == \
        [([0, 24], [16, 9]), ([0, 24], [16])]
    tracer.active = False
    model.paged_decode_step(token, pool, table, lengths)
    assert len(tracer._decode) == 1


def test_a_configuration_without_arch_is_passed_through_whole():
    pytest.importorskip("repro_torch")
    m = copy.deepcopy(MOE)
    named = dict(m, arch="gqa")
    assert cell.model_config(named) == cell.model_config(m)
