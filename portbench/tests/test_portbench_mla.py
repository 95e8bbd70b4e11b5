"""The ``mla`` architecture (``archs/mla.py``) and its cell: the layout's
bytes at deepseek-v2-l30e20, the latent pool's bytes a token and pages,
the FLOPs and the latent kernel's cost against hand counts, the two
copies of the reference (the port's ``deepseek_v2_ref.py`` and this
one) on the same float32 logits, a served window of a tiny configuration
judged correct by it on the CPU, and the cell's readers on a fixture
trace."""
import contextlib
import io
import json
import pathlib

import pytest
import torch

from portbench import archs
from portbench.harness import cell, driver
from portbench.harness.spec import Bench
from portbench.harness.tracing import DecodeCall, PrefillCall, Trace
from portbench.reference import weights as W
from portbench.tests.fixtures import ENGINE, NODES, make_root
from portbench.yardstick.costs import kernel_time_bound

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
_GIB = 1 << 30

TINY = {
    "arch": "mla", "name": "tiny-mla", "family": "moe", "num_layers": 3,
    "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 24,
    "d_ff": 96, "vocab_size": 256, "rope_theta": 10000.0, "norm_eps": 1e-6,
    "dtype": "float32", "param_dtype": "float32",
    "mla": {"q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16, "rope_factor": 40.0,
            "original_max_position": 64, "beta_fast": 32.0, "beta_slow": 1.0,
            "mscale": 0.707, "mscale_all_dim": 0.707},
    "moe": {"num_experts": 16, "top_k": 3, "d_ff_expert": 32,
            "num_shared_experts": 2, "first_dense_layers": 1,
            "d_ff_dense": 96},
    "routing": {"n_group": 4, "topk_group": 2, "routed_scaling_factor": 16.0,
                "held_start": 4, "held_count": 4}}


def _dsv2():
    return json.loads((PB / "configs" / "deepseek-v2-l30e20.json")
                      .read_text())


def test_the_configuration_is_the_catalogs_cut_in_depth_and_experts():
    conf = _dsv2()
    pub = conf["published"]
    for k, v in pub.items():
        want = {"num_hidden_layers": 30, "n_routed_experts": 20}.get(k, v)
        assert conf[k] == want, k
    assert set(conf["reduced"]) == {"num_hidden_layers", "n_routed_experts"}
    m = conf["model"]
    assert archs.arch_name(m) == "mla"
    assert m["num_layers"] == 30 and m["routing"]["held_count"] == 20
    assert m["moe"]["num_experts"] == pub["n_routed_experts"] == 160
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "deepseek-v2-l30e20")
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])


def test_layout_bytes_pool_and_pages():
    """Weights by hand: per MLA layer 149,227,520 parameters and two norms,
    the dense lead FFN 3 x 5120 x 12288, per expert layer 20 held experts
    of 3 x 5120 x 1536, two shared (one SwiGLU of 3072) and the float32
    router 5120 x 160; the embedding and the head 102,400 x 5120 each."""
    m = _dsv2()["model"]
    arch = Bench(ROOT).arch("mla")
    d = 5120
    mla = d * 1536 + 1536 + 1536 * 128 * 192 + d * 576 + 512 \
        + 512 * 128 * 256 + 128 * 128 * d
    assert mla - 1536 - 512 == 149_225_472
    bf16 = 2 * 102_400 * d + d + 30 * (mla + 2 * d) + 3 * d * 12288 \
        + 29 * (20 * 3 * d * 1536 + 3 * d * 3072)
    want = 2 * bf16 + 4 * 29 * d * 160
    assert cell.param_bytes(m, arch) == want == 41_628_559_360
    assert arch.kv_bytes_per_token(m) == 576 * 4 * 30 == 69_120
    eng = {"page_size": 8, "activation_reserve_gb": 6}
    free = 84_460_000_000
    pages = cell.pool_pages(m, eng, free, arch)
    assert pages == (free - want - 6 * _GIB) // (8 * 69_120) == 65_807
    # 768 rows of the traffic's longest call (512 + 96 tokens, 76 pages)
    assert 768 * 76 <= pages


def test_token_flops_and_the_latent_kernels_cost():
    m = _dsv2()["model"]
    arch = Bench(ROOT).arch("mla")
    d = 5120
    attn = d * 1536 + 1536 * 24576 + d * 576 + 512 * 32768 + 16384 * d
    per_token = 102_400 * d + 30 * attn + 3 * d * 12288 \
        + 29 * (d * 160 + (6 * 20 / 160 + 2) * 3 * d * 1536)
    assert arch.matmul_params(m) == pytest.approx(per_token, rel=1e-15)
    per_key = 2 * 128 * (128 + 64 + 128) * 30
    assert arch.token_flops(m, [1, 300, 608]) == pytest.approx(
        2 * per_token * 3 + per_key * 909, rel=1e-15)
    nbytes, flops = arch.latent_decode_cost(m, 8, [0, 337, -1])
    keys = 1 + 338
    assert nbytes == keys * 576 * 4 + 2 * 128 * (576 + 512) * 2
    assert flops == 2 * 128 * (576 + 512) * keys
    assert arch.latent_decode_cost(m, 8, [-1, -1]) == (0.0, 0.0)
    # the flash kernel in prefill: 128 heads zero-padded to 256, bf16
    assert arch.flash_width(m) == 256
    nbytes, flops = arch.prefill_flash_cost(m, 100, 50)
    assert nbytes == 2 * 50 * 128 * 256 * 2 + 2 * 150 * 128 * 256 * 2
    pairs = 50 * 100 + 50 * 51 // 2
    assert flops == 4 * 128 * 256 * pairs
    # the model's own share of those operations: 2 x (192 + 128) of 4 x 256
    assert 2 * 128 * (192 + 128) * pairs / flops == 0.625


def _seqs():
    g = torch.Generator().manual_seed(7)
    return [(torch.randint(0, 250, (n,), generator=g).tolist(),
             torch.randint(0, 250, (k,), generator=g).tolist())
            for n, k in ((21, 5), (9, 3))]


def test_the_two_copies_of_the_reference_agree():
    """The port's reference over a state dict drawn from the layout and
    the benchmark's copy, which draws the same tensors layer by layer:
    equal float32 logits."""
    pytest.importorskip("repro_torch")
    from repro_torch.engine.models import deepseek_v2_ref as R
    arch = Bench(ROOT).arch("mla")
    seed = 2**31 + 9
    lay = arch.layout(TINY)
    sd = {k: W.draw(e, seed, k, "cpu") for k, e in lay.items()}
    cfg = cell.model_config(TINY)
    seqs = _seqs()
    ours = arch.served_logits(TINY, seed, seqs, device="cpu")
    for (prompt, served), got in zip(seqs, ours):
        want = R.logits(cfg, sd, prompt + served[:-1])[len(prompt) - 1:]
        assert torch.equal(got, want)
    low = arch.served_logits(TINY, seed, seqs, device="cpu",
                             precision="fp8")
    assert not torch.equal(low[0], ours[0])


def _mla_root(tmp_path, model):
    root = make_root(tmp_path)
    pb = root / "portbench"
    (pb / "configs" / "tiny-mla.json").write_text(json.dumps(
        {"source": "test", "model": model, "engine": ENGINE}))
    (pb / "traffic" / "tiny_nodes.json").write_text(json.dumps(NODES))
    (pb / "cells" / "mla.nodes.json").write_text(json.dumps(
        {"max_batch": 4, "correct": {"reference_calls": 4,
                                     "logit_gap": 1e-3}}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-mla", "source": "test",
                           "file": "portbench/configs/tiny-mla.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "mla.nodes", "config": "tiny-mla",
                             "traffic": "tiny_nodes", "chips": 1,
                             "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


def test_a_served_window_is_judged_by_the_mla_reference(tmp_path):
    """Set-up fills the port's latent model from the layout, the engine
    serves the traffic's first calls, and the check, by this
    architecture's reference, finds every served token the reference's
    best (float32 on the CPU); the fp8 control's gaps are wider."""
    pytest.importorskip("repro_torch")
    bench = Bench(_mla_root(tmp_path, TINY))
    seed = 2**33 + 1
    with contextlib.redirect_stderr(io.StringIO()):
        s = cell.set_up(bench, "mla.nodes", seed, "cpu", warm=False)
        assert type(s.engine.model).__name__ == "MLATransformerLM"
        assert s.engine.kv is None or s.engine.kv.v is None
        calls = [s.traffic.call(i) for i in range(6)]
        handles = [s.engine.submit(c.prompt, max_new_tokens=c.max_new,
                                   temperature=0.0) for c in calls]
        recs = [driver.Record(c, due=0.0, done=1.0, tokens=h.result())
                for c, h in zip(calls, handles)]
        stats = s.engine.stats.as_dict()
        cell.tear_down(s)
    assert stats["moe_layer_calls"] > 0 and stats["expert_slots_held"] > 0
    data = cell.RunData(s.cell, s.model, 1.0, 0.0,
                        driver.Window(recs, 0.0, 2.0, 2.0), stats, 8)
    port, ctrl = cell.judge(data, seed, s.device, s.engine_cfg, control=True)
    assert cell.correct(port), port
    assert port["logit_gap"]["value"] <= 1e-3
    assert ctrl["logit_gap"]["value"] > port["logit_gap"]["value"]


def test_the_new_readers_on_a_fixture_trace():
    bench = Bench(ROOT)
    c = bench.cell("dsv2.halo_nodes")
    m = c.config["model"]
    trace = Trace(window_s=2.0, busy_s=1.0,
                  decode=[DecodeCall(1.0, [10, -1, 300]),
                          DecodeCall(1.0, [11, 301])],
                  prefill=[PrefillCall(1.0, [0, 96], [290, 7]),
                           PrefillCall(1.0, [0], [512])],
                  kernel_s={"latent_decode_kernel": 0.05,
                            "paged_split_kernel": 9.0,
                            "tc::flash_tc_kernel<256>": 0.2})
    run = cell.RunData(c, m, 2.0, 0.0, None,
                       {"expert_slots_held": 5760, "moe_layer_calls": 290},
                       8, trace)
    bound = sum(kernel_time_bound(*c.arch.latent_decode_cost(m, 8, ln))
                for ln in ([10, -1, 300], [11, 301]))
    assert bench.reader("latent_roofline.dsv2")(run) == pytest.approx(
        100.0 * bound * 30 / 0.05, rel=1e-12)
    assert bench.reader("expert_rows_per_call.dsv2")(run) == \
        pytest.approx(5760 / (290 * 20))
    flash = sum(kernel_time_bound(*c.arch.prefill_flash_cost(m, p0, n))
                for p0, n in ((0, 290), (96, 7), (0, 512)))
    assert bench.reader("mla_flash_roofline.dsv2")(run) == pytest.approx(
        100.0 * flash * 30 / 0.2, rel=1e-12)
    # the host spans and counters of every engine read the same on it
    spans = {"span_n.engine.decode": 4, "span_self_s.engine.decode": 0.02,
             "span_n.engine.admit.model": 5, "host_syncs": 40}
    run.stats = dict(run.stats, **spans)
    for name in ("host_syncs_per_call", "decode_host_ms_per_step",
                 "admit_host_ms_per_call"):
        assert bench.reader(name + ".dsv2")(run) == \
            bench.reader(name + ".batch")(run)
    assert bench.reader("host_syncs_per_call.dsv2")(run) == 8.0
    # a program that ran no latent kernel and counts no slots reads none
    run.trace = Trace(2.0, 1.0, [DecodeCall(1.0, [3])], [], {"paged": 1.0})
    run.stats = {}
    assert bench.reader("latent_roofline.dsv2")(run) is None
    assert bench.reader("expert_rows_per_call.dsv2")(run) is None
    assert bench.reader("mla_flash_roofline.dsv2")(run) is None
    gqa = bench.cell("ds67b.halo_nodes")
    run = cell.RunData(gqa, gqa.config["model"], 2.0, 0.0, None, {}, 8, trace)
    assert bench.reader("latent_roofline.dsv2")(run) is None
    assert bench.reader("mla_flash_roofline.dsv2")(run) is None
    # the cell reports them, and calls_per_s
    names = [x["name"] for x in bench.metrics("dsv2.halo_nodes", True)]
    assert {"latent_roofline.dsv2", "expert_rows_per_call.dsv2",
            "mla_flash_roofline.dsv2", "decode_host_ms_per_step.dsv2",
            "admit_host_ms_per_call.dsv2",
            "host_syncs_per_call.dsv2"} <= set(names)
    assert [x["name"] for x in bench.metrics("dsv2.halo_nodes", False)] == \
        ["calls_per_s", "setup_s"]


def test_the_guard_scans_the_mla_module():
    assert PB / "archs" / "mla.py" in sorted((PB / "archs").glob("*.py"))
    text = (PB / "archs" / "mla.py").read_text()
    assert "repro_torch" not in text.split('"""', 2)[2]
