"""The traffic generator: deterministic per seed, stratified per block,
the stated distributions."""
import math
from collections import Counter

import pytest

from portbench.harness.traffic import Traffic

SHARED = {"loop": "closed", "outstanding": 8, "block": 16,
          "segments": [{"shared": 4, "tokens": 64},
                       {"tokens": {"log_uniform": [128, 1024]}}],
          "max_new_tokens": [24, 48, 64, 96]}
OPEN = {"loop": "open", "rate_per_s": 5.0, "block": 16,
        "segments": [{"shared": 2, "tokens": 32},
                     {"tokens": {"log_uniform": [256, 2048]}},
                     {"tokens": 32}],
        "max_new_tokens": [24, 48, 64, 96]}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_same_seed_same_calls(seed):
    a = Traffic(SHARED, seed, (0, 100000))
    b = Traffic(SHARED, seed, (0, 100000))
    for i in (0, 5, 17, 40):
        assert a.call(i) == b.call(i)
    c = Traffic(SHARED, seed + 1, (0, 100000))
    assert a.call(3).prompt != c.call(3).prompt


def test_blocks_hold_the_same_work_in_another_order():
    """Every block of calls holds the same lengths, templates and output
    lengths, whatever the seed."""
    def block(seed, b):
        t = Traffic(SHARED, seed, (0, 100000))
        calls = [t.call(i) for i in range(16 * b, 16 * (b + 1))]
        return (sorted(len(c.prompt) for c in calls),
                Counter(c.variant for c in calls),
                Counter(c.max_new for c in calls))
    ref = block(1, 0)
    for seed, b in ((1, 1), (2, 0), (99, 3)):
        assert block(seed, b) == ref
    t1, t2 = Traffic(SHARED, 1, (0, 10)), Traffic(SHARED, 2, (0, 10))
    assert [t1.call(i).max_new for i in range(16)] != \
        [t2.call(i).max_new for i in range(16)]


def test_lengths_log_uniform_and_shares_equal():
    t = Traffic(SHARED, 3, (0, 100000))
    calls = [t.call(i) for i in range(64)]
    suffix = sorted(len(c.prompt) - 64 for c in calls)
    assert 128 <= suffix[0] and suffix[-1] <= 1024
    # stratified quantiles of log-uniform(128, 1024): the median is ~362
    med = suffix[len(suffix) // 2]
    assert abs(math.log(med) - 0.5 * (math.log(128) + math.log(1024))) < 0.1
    assert Counter(c.variant for c in calls) == {0: 16, 1: 16, 2: 16, 3: 16}
    assert Counter(c.max_new for c in calls) == {24: 16, 48: 16, 64: 16,
                                                 96: 16}
    # a template's tokens are the same in every call that uses it
    by_var = {}
    for c in calls:
        by_var.setdefault(c.variant, set()).add(c.prompt[:64])
    assert all(len(v) == 1 for v in by_var.values())
    assert all(0 <= tok < 100000 for c in calls for tok in c.prompt)


def test_open_loop_arrivals_at_the_rate():
    t = Traffic(OPEN, 11, (0, 100000))
    dues = [t.call(i).due for i in range(160)]
    assert all(b > a for a, b in zip(dues, dues[1:]))
    # each block's gaps are the stratified exponential quantiles, so the
    # block's span is fixed: 16 gaps of mean 1/rate (about 0.2 s)
    assert dues[-1] == pytest.approx(160 / 5.0, rel=0.05)
    prompt = t.call(0).prompt
    assert 1024 // 32 <= len(prompt) - 64 <= 2048 + 32
    assert len(Traffic(OPEN, 11, (0, 10)).shared_prompts()) == 2


NODES = {"loop": "closed", "outstanding": 8, "block": 4,
         "segments": [{"shared": 2, "tokens": 16}, {"tokens": "node"}],
         "max_new_tokens": "node",
         "nodes": [{"node": "a", "prompt_tokens": 96, "max_new_tokens": 24},
                   {"node": "b", "prompt_tokens": 256, "max_new_tokens": 48},
                   {"node": "c", "prompt_tokens": 512, "max_new_tokens": 96},
                   {"node": "d", "prompt_tokens": 320, "max_new_tokens": 64}]}


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_nodes_in_equal_shares_with_their_own_lengths(seed):
    """Each block holds every node once; a call's unique part and output
    are its node's lengths."""
    t = Traffic(NODES, seed, (0, 100000))
    calls = [t.call(i) for i in range(16)]
    want = {(n["prompt_tokens"], n["max_new_tokens"]) for n in NODES["nodes"]}
    for b in range(4):
        block = calls[4 * b:4 * (b + 1)]
        assert {(len(c.prompt) - 16, c.max_new) for c in block} == want
    assert t.longest_prompt() == 16 + 512
    assert [c.max_new for c in calls] != \
        [Traffic(NODES, seed + 1, (0, 100000)).call(i).max_new
         for i in range(16)]


@pytest.mark.parametrize("name", ["halo_nodes_c192.json",
                                  "halo_nodes_c64.json"])
def test_the_checked_in_node_mix_is_the_library_s(name):
    """``traffic/halo_nodes_*.json`` hold every LLM node of W1-W6 with the
    workflow library's lengths, one block a pass over them."""
    import json
    import pathlib
    pb = pathlib.Path(__file__).resolve().parents[1]
    spec = json.loads((pb / "traffic" / name).read_text())
    assert spec["block"] == len(spec["nodes"]) == 52
    lib = pytest.importorskip("repro_torch.workloads.library")
    want = []
    for name in ("w1", "w2", "w3", "w4", "w5", "w6"):
        wf, _ = lib.WORKFLOWS[name]()
        want += [(n["est_prompt_tokens"], n["max_new_tokens"])
                 for n in wf["nodes"] if n.get("type") == "llm"]
    assert [(n["prompt_tokens"], n["max_new_tokens"])
            for n in spec["nodes"]] == want
