"""The paged kernel's variant sweep on the card, and the table it writes.

    python -m repro_torch.kernels.paged_decode_attention.tune [--json]
    python -m repro_torch.kernels.paged_decode_attention.tune --persist \\
        [--out PATH]

For each paged architecture's key (``ops.shape_key`` at the engine's page
size: every config whose model keeps a page pool, ``paged_kv_layout()``
not None) the sweep times each distinct candidate of the decode step's
attention over a grid of batch sizes and lengths (``BATCHES`` x
``LENGTHS``: one chunk of keys, and a table that splits), with the
engine's dtypes: q in bf16, the pool in f32, a shuffled pool drawn from a
seeded ``torch.Generator``.  The candidates are ``single``, ``blocked``
and ``fused`` at every ``pages_per_block`` of ``ops.PAGES_PER_BLOCK``,
deduplicated by the stage of the copy ring that ``ops.stage_pages``
gives them (one kernel for every ``pages_per_block`` that reaches the
same stage), each kept under the smallest ``pages_per_block`` that
reaches its stage.

Equal work: ``fused`` appends the new K/V rows inside the kernel, so the
attend-only arms are timed together with the step's own append of those
rows (``ops.append_rows_`` into both pools, at the targets that
``ops.append_targets`` computes once a step), the ops a model's decode
step runs for each layer.  This is where it departs from the JAX
package's ``benchmarks/kernel_bench.py``, which times ``fused`` with its
append and the others without any.

Each time is the median of CUDA-event times over back-to-back calls
after a warm-up, the candidates of one grid point taking turns, in one
process.  A candidate's score at a key is the sum of its medians over the
grid; the lowest wins.  ``--persist`` writes ``autotune.json`` beside
``ops.py`` (or ``--out``): each key's winner, a ``"default"`` entry (the
winner of the scores summed over all keys), every candidate's times, and
where they were taken (``_provenance``: the card's name and power limit
from ``nvidia-smi``, the torch and CUDA versions, the date, the command,
the peaks of ``configs/base.py``).  Off the card the sweep times nothing:
it prints why and exits with 2, and ``--persist`` writes nothing.
"""
from __future__ import annotations

import argparse
import datetime
import inspect
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.kernels.paged_decode_attention import ops

BATCHES = (8, 32)
LENGTHS = (63, 511)         # positions of the new token: 64 and 512 keys
WARMUP = 5
REPS = 30
SEED = 0
COMMAND = "python -m repro_torch.kernels.paged_decode_attention.tune"


def engine_page_size() -> int:
    """The ``InferenceEngine``'s default page size, the pools it serves
    from."""
    from repro_torch.engine.engine import InferenceEngine
    return inspect.signature(InferenceEngine.__init__).parameters[
        "page_size"].default


def paged_shapes(page_size: Optional[int] = None) -> Dict[str, Dict]:
    """``{key: {"page_size", "kv_heads", "head_dim", "group", "archs"}}``
    for every config whose model keeps its KV in pages (a copy one block
    pattern deep, built on meta tensors, is asked), at the engine's page
    size unless
    ``page_size`` is given."""
    from repro_torch.configs import all_configs
    from repro_torch.engine.models import build_model
    ps = page_size or engine_page_size()
    out: Dict[str, Dict] = {}
    for arch, cfg in all_configs().items():
        model = build_model(cfg.replace(num_layers=len(cfg.block_pattern)
                                        or 1), device="meta")
        layout = model.paged_kv_layout()
        if layout is None:
            continue
        _, hkv, dh = layout
        g = cfg.num_heads // cfg.num_kv_heads
        key = ops.shape_key(ps, hkv, dh, g)
        out.setdefault(key, {"page_size": ps, "kv_heads": hkv,
                             "head_dim": dh, "group": g, "archs": []})
        out[key]["archs"].append(arch)
    return out


def label(variant: str, pages_per_block: int) -> str:
    return variant if variant == "single" else \
        f"{variant}@{pages_per_block}"


def candidate(variant: str, pages_per_block: int, page_size: int,
              head_dim: int, name: Optional[str] = None,
              elem_bytes: int = 4) -> Dict:
    """A candidate with the stage its kernel runs at this shape (one page
    for ``single``), named ``name`` or by its variant and pages."""
    stage = 1 if variant == "single" else ops.stage_pages(
        pages_per_block, page_size, head_dim, elem_bytes,
        ops.plan_chunk_pages(page_size, head_dim))
    return {"variant": variant, "pages_per_block": pages_per_block,
            "stage": stage, "label": name or label(variant, pages_per_block)}


def candidates(page_size: int, head_dim: int,
               elem_bytes: int = 4) -> List[Dict]:
    """The distinct candidates at a shape: ``single``, then ``blocked``
    and ``fused`` at each ``pages_per_block``, one for each (attend-only
    or fused, stage), each under the first ``pages_per_block`` (the
    smallest) that reaches its stage."""
    seen, out = set(), []
    for variant, ppbs in (("single", (1,)), ("blocked", ops.PAGES_PER_BLOCK),
                          ("fused", ops.PAGES_PER_BLOCK)):
        for ppb in ppbs:
            c = candidate(variant, ppb, page_size, head_dim,
                          elem_bytes=elem_bytes)
            kind = (variant == "fused", c["stage"])
            if kind not in seen:
                seen.add(kind)
                out.append(c)
    return out


def make_inputs(shape: Dict, batch: int, length: int) -> Dict:
    """A decode step's inputs at ``shape``: every row ``length`` tokens
    before the new one, its pages drawn from a pool of twice the pages
    the batch holds, shuffled; q in bf16, pool and new K/V in f32."""
    ps, hkv, dh = shape["page_size"], shape["kv_heads"], shape["head_dim"]
    h = hkv * shape["group"]
    device = "cuda"
    g = torch.Generator(device=device).manual_seed(SEED)
    n_pages = length // ps + 1
    P = 2 * batch * n_pages

    def normal(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g, device=device).to(dtype)

    table = torch.randperm(P, generator=g, device=device)[:batch * n_pages]
    inputs = {"q": normal(batch, h, dh, dtype=torch.bfloat16),
              "k_pages": normal(P, ps, hkv, dh),
              "v_pages": normal(P, ps, hkv, dh),
              "page_table": table.view(batch, n_pages).int().contiguous(),
              "lengths": torch.full((batch,), length, dtype=torch.int32,
                                    device=device),
              "k_new": normal(batch, hkv, dh),
              "v_new": normal(batch, hkv, dh)}
    inputs["targets"] = ops.append_targets(inputs["page_table"],
                                           inputs["lengths"], ps)
    return inputs


def candidate_call(cand: Dict, x: Dict) -> Callable[[], torch.Tensor]:
    """One layer's append and attention under ``cand``: ``fused`` alone,
    the attend-only arms after the step's append into both pools."""
    if cand["variant"] == "fused":
        def call():
            return ops.fused_paged_decode_attention(
                x["q"], x["k_pages"], x["v_pages"], x["page_table"],
                x["lengths"], x["k_new"], x["v_new"],
                pages_per_block=cand["pages_per_block"])[0]
    else:
        def call():
            ops.append_rows_(x["k_pages"], x["targets"], x["k_new"])
            ops.append_rows_(x["v_pages"], x["targets"], x["v_new"])
            return ops.paged_decode_attention(
                x["q"], x["k_pages"], x["v_pages"], x["page_table"],
                x["lengths"], variant=cand["variant"],
                pages_per_block=cand["pages_per_block"])
    return call


def median_ms(calls: Dict[str, Callable]) -> Dict[str, float]:
    """Median CUDA-event milliseconds of each call: ``WARMUP`` calls each,
    then ``REPS`` rounds in which every call runs once, back to back."""
    for fn in calls.values():
        for _ in range(WARMUP):
            fn()
    torch.cuda.synchronize()
    marks = {k: [] for k in calls}
    for _ in range(REPS):
        for k, fn in calls.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            marks[k].append((start, end))
    torch.cuda.synchronize()
    return {k: statistics.median(s.elapsed_time(e) for s, e in v)
            for k, v in marks.items()}


def time_key(shape: Dict, cands: Sequence[Dict]) -> Dict[str, Dict]:
    """``{label: {"variant", "pages_per_block", "stage", "ms": {"B8-L63":
    ms, ...}, "score_ms"}}`` of ``cands`` at ``shape`` over the grid."""
    out = {c["label"]: {"variant": c["variant"],
                        "pages_per_block": c["pages_per_block"],
                        "stage": c["stage"], "ms": {}} for c in cands}
    for b in BATCHES:
        for n in LENGTHS:
            x = make_inputs(shape, b, n)
            times = median_ms({c["label"]: candidate_call(c, x)
                               for c in cands})
            for k, ms in times.items():
                out[k]["ms"][f"B{b}-L{n}"] = ms
            del x
    for r in out.values():
        r["score_ms"] = sum(r["ms"].values())
    return out


def winner(timed: Dict[str, Dict]) -> Dict:
    """The entry of the lowest score (the first listed on a tie)."""
    best = min(timed, key=lambda k: timed[k]["score_ms"])
    return {k: timed[best][k] for k in ("variant", "pages_per_block",
                                        "stage")}


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sweep(argv: Sequence[str] = ()) -> Dict:
    """Time every key's candidates on the card; the table ``--persist``
    writes."""
    from repro_torch.configs.base import (HBM_BW, PEAK_FLOPS_BF16,
                                          PEAK_FLOPS_F32)
    shapes = paged_shapes()
    timed, configs = {}, {}
    for key, shape in shapes.items():
        cands = candidates(shape["page_size"], shape["head_dim"])
        timed[key] = time_key(shape, cands)
        configs[key] = winner(timed[key])
    totals: Dict[str, Dict] = {}
    for key, rows in timed.items():
        for name, r in rows.items():
            t = totals.setdefault(name, {**r, "score_ms": 0.0, "keys": 0})
            t["score_ms"] += r["score_ms"]
            t["keys"] += 1
    everywhere = {k: t for k, t in totals.items() if t["keys"] == len(timed)}
    configs = {"default": winner(everywhere), **configs}
    return {
        "_provenance": {
            "card": nvidia_smi_line(),
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"),
            "command": " ".join([COMMAND, *argv]),
            "peaks": {"hbm_bw": HBM_BW, "flops_bf16": PEAK_FLOPS_BF16,
                      "flops_f32": PEAK_FLOPS_F32},
            "grid": {"batches": list(BATCHES), "lengths": list(LENGTHS),
                     "q": "bfloat16", "pool": "float32", "seed": SEED,
                     "reps": REPS, "warmup": WARMUP},
            "archs": {k: s["archs"] for k, s in shapes.items()}},
        "configs": configs,
        "sweep": timed,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--persist", action="store_true",
                    help="write the table (autotune.json beside ops.py)")
    ap.add_argument("--out", default=None, help="where --persist writes")
    ap.add_argument("--json", action="store_true",
                    help="print the table as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune: no CUDA device: the sweep times the kernel on the "
              "card and nothing else; nothing was timed"
              + (" and no table was written" if args.persist else ""),
              file=sys.stderr)
        return 2
    table = sweep(list(sys.argv[1:] if argv is None else argv))
    if args.json:
        print(json.dumps(table, indent=1))
    else:
        print(f"card: {table['_provenance']['card']}")
        for key, rows in table["sweep"].items():
            for name, r in rows.items():
                print(f"{key:20s} {name:10s} stage={r['stage']} "
                      + " ".join(f"{g}={ms:.4f}ms"
                                 for g, ms in r["ms"].items())
                      + f" score={r['score_ms']:.4f}ms")
        for key, kc in table["configs"].items():
            print(f"winner {key:20s} {json.dumps(kc)}")
    if args.persist:
        path = args.out or ops._DEFAULT_TABLE
        with open(path, "w") as f:
            json.dump(table, f, indent=1)
            f.write("\n")
        ops._load_table.cache_clear()
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
