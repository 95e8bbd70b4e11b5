"""A benchmark root defined only here: a tiny configuration of each
family, its traffic and its cells, as files beside a BENCHMARK.json of
their own.  The harness finds them by name, with no edit of its code."""
from __future__ import annotations

import json
import pathlib

DENSE = {
    "name": "tiny-dense", "family": "dense", "num_layers": 3, "d_model": 64,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
    "vocab_size": 256, "rope_theta": 10000.0, "norm_eps": 1e-6,
    "dtype": "bfloat16", "param_dtype": "bfloat16"}
MOE = {
    "name": "tiny-moe", "family": "moe", "num_layers": 3, "d_model": 64,
    "num_heads": 4, "num_kv_heads": 4, "head_dim": 16, "d_ff": 96,
    "vocab_size": 256, "rope_theta": 10000.0, "norm_eps": 1e-6,
    "dtype": "bfloat16", "param_dtype": "bfloat16",
    "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 96,
            "num_shared_experts": 1, "first_dense_layers": 1,
            "d_ff_dense": 128, "capacity_factor": 1.25}}
ENGINE = {"page_size": 8, "max_seq_len": 512, "prefill_quantum": 16,
          "num_pages": 256, "token_ids": [0, 250]}
CLOSED = {"loop": "closed", "outstanding": 6, "block": 8,
          "segments": [{"shared": 2, "tokens": 24},
                       {"tokens": {"log_uniform": [8, 40]}}],
          "max_new_tokens": [6, 12]}
UNIQUE = {"loop": "closed", "outstanding": 6, "block": 8,
          "segments": [{"tokens": {"log_uniform": [20, 60]}}],
          "max_new_tokens": [6, 12]}
NODES = {"loop": "closed", "outstanding": 6, "block": 3,
         "segments": [{"tokens": "node"}], "max_new_tokens": "node",
         "nodes": [{"node": "a", "prompt_tokens": 12, "max_new_tokens": 6},
                   {"node": "b", "prompt_tokens": 40, "max_new_tokens": 12},
                   {"node": "c", "prompt_tokens": 24, "max_new_tokens": 8}]}
OPEN = {"loop": "open", "rate_per_s": 20.0, "block": 8, "warm_shared": True,
        "segments": [{"shared": 2, "tokens": 24},
                     {"tokens": {"log_uniform": [8, 40]}}, {"tokens": 4}],
        "max_new_tokens": [6, 12]}
# limits set from readings at this size (12 seeds each, 8 calls of 6-12
# served tokens): sound dense runs' widest gap 0-0.07, the fp8 control's
# 0.26-0.84, a broken step's 0.9-6.1; sound MoE runs' mean gap 0-0.021
GAP = 0.15
MOE_GAP_MEAN = 0.06


def make_root(tmp: pathlib.Path, gap: float = GAP) -> pathlib.Path:
    pb = tmp / "portbench"
    for d in ("configs", "traffic", "cells"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    configs = []
    for name, model in (("tiny-dense", DENSE), ("tiny-moe", MOE)):
        (pb / "configs" / f"{name}.json").write_text(json.dumps(
            {"source": "test", "model": model, "engine": ENGINE}))
        configs.append({"name": name, "source": "test",
                        "file": f"portbench/configs/{name}.json",
                        "reduced": [], "why": "test"})
    (pb / "traffic" / "tiny_closed.json").write_text(json.dumps(CLOSED))
    (pb / "traffic" / "tiny_open.json").write_text(json.dumps(OPEN))
    (pb / "traffic" / "tiny_unique.json").write_text(json.dumps(UNIQUE))
    (pb / "traffic" / "tiny_nodes.json").write_text(json.dumps(NODES))
    cells = [("dense.closed", "tiny-dense", "tiny_closed"),
             ("moe.closed", "tiny-moe", "tiny_unique"),
             ("dense.open", "tiny-dense", "tiny_open"),
             ("moe.nodes", "tiny-moe", "tiny_nodes")]
    for name, config, _ in cells:
        limit = ({"logit_gap_mean": MOE_GAP_MEAN} if config == "tiny-moe"
                 else {"logit_gap": gap})
        (pb / "cells" / f"{name}.json").write_text(json.dumps(
            {"max_batch": 4, "correct": {"reference_calls": 4, **limit}}))
    doc = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"],
        "run_seconds": 2, "configs": configs,
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "test"} for n, c, t in cells],
        "end_to_end": [
            {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["dense.closed", "moe.closed", "moe.nodes"]},
            {"name": "call_p90_ms", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["dense.open"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "prefix_hit_share.batch", "unit": "%",
             "better": "higher", "source": "program_counter",
             "layer": "KV store", "moves": "calls_per_s"}]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp
