"""One run of one cell: set-up, the window, the check, the metrics.

Set-up builds the port's engine with the cell's settings, fills its
parameters in place with the benchmark's weights (``reference.weights``
in the layout of the configuration's architecture, ``archs/``, so the
card holds one copy) and hands them to ``load``, warms the
shapes the cell's traffic uses, and prefills the shared prompts that its
traffic asks to have warm.  The window drives ``InferenceEngine.submit``
through the loop the traffic names (``loops/``).  Afterwards the peak memory is
read, the engine is shut down and freed, and the reference judges a
sample of the finished calls (``check``).
"""
from __future__ import annotations

import gc
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check, driver, guard
from portbench.harness.spec import Bench, Cell
from portbench.harness.stats import latencies_ms
from portbench.harness.tracing import Trace, Tracer
from portbench.harness.traffic import Traffic
from portbench.reference import weights as W

_GIB = 1 << 30


def log(*parts) -> None:
    print("[portbench]", *parts, file=sys.stderr, flush=True)


@dataclass
class RunData:
    """What the metric readers read."""
    cell: Cell
    model: dict
    seconds: float
    setup_s: float
    window: driver.Window
    stats: Dict[str, float]          # EngineStats deltas over the window
    page_size: int
    trace: Optional[Trace] = None

    def in_window(self) -> List[driver.Record]:
        """Calls that count: where the loop drained, every call due in
        the window; otherwise those that finished inside it."""
        if self.window.drained:
            return self.window.records
        return [r for r in self.window.records
                if r.done is not None and r.done <= self.window.closed]

    def latencies_ms(self) -> List[float]:
        recs = self.window.records
        return latencies_ms([r.due for r in recs], [r.done for r in recs],
                            self.window.gave_up)


def model_config(model: dict):
    """The port's ``ModelConfig`` for a configuration file's ``model``:
    the section's fields but ``arch``, passed through (where the
    architecture gives ``port_config``, set-up takes that)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    fields = dict(model)
    fields.pop("arch", None)
    moe = fields.pop("moe", None)
    return ModelConfig(moe=MoEConfig(**moe) if moe else None, **fields)


def param_bytes(model: dict, arch) -> int:
    return sum(int(np.prod(shape)) * torch.empty((), dtype=getattr(
        torch, dt)).element_size()
        for shape, dt, _ in arch.layout(model).values())


def pool_pages(model: dict, engine_cfg: dict, free: Optional[int],
               arch) -> int:
    """Pages that fill ``free`` bytes of the card less the weights and the
    configuration's reserve for activations, at the architecture's pool
    bytes a token; ``free`` is not read where the configuration fixes
    ``num_pages``."""
    if "num_pages" in engine_cfg:
        return int(engine_cfg["num_pages"])
    left = free - param_bytes(model, arch) \
        - int(float(engine_cfg["activation_reserve_gb"]) * _GIB)
    page = engine_cfg["page_size"] * arch.kv_bytes_per_token(model)
    if left < page * 64:
        raise MemoryError(f"{left / _GIB:.1f} GiB left for the KV pool")
    return left // page


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _warm_up(engine, traffic: Traffic, serve: dict, seed: int) -> None:
    """Run once what the window will: the traffic's longest prompt, a
    prefill over aliased pages, a decode step at the full batch.  Then
    free what it left warm."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 99])

    def toks(n):
        return [int(t) for t in rng.integers(traffic.lo, traffic.hi, n)]

    longest = toks(traffic.longest_prompt())
    engine.submit(longest, max_new_tokens=2, temperature=0.0).result()
    hs = [engine.submit(longest[:64] + toks(48), max_new_tokens=2,
                        temperature=0.0)]
    hs += [engine.submit(toks(32), max_new_tokens=2, temperature=0.0)
           for _ in range(int(serve["max_batch"]))]
    for h in hs:
        h.result()
    engine.release_warm()


def _stop(engine, name: str) -> None:
    """Shut the engine down and wait until its loop thread has ended."""
    engine.shutdown()
    for t in threading.enumerate():
        if t.name == f"engine-{name}":
            t.join(timeout=300)
            if t.is_alive():
                raise RuntimeError("the engine loop did not stop")


@dataclass
class Setup:
    cell: Cell
    model: dict
    engine_cfg: dict
    traffic: Traffic
    engine: object
    name: str                        # the engine loop thread's suffix
    num_pages: int
    device: torch.device
    loop: Callable                   # loops/<traffic loop>.py's run


def set_up(bench: Bench, name: str, seed: int, device: str = "cuda",
           warm: bool = True) -> Setup:
    """The engine with the cell's settings, loaded with the benchmark's
    weights for ``seed``; with ``warm``, every shape of the window run
    once and the traffic's shared prompts prefilled where it asks."""
    from repro_torch.engine.engine import InferenceEngine

    dev = torch.device(device)
    cell = bench.cell(name)
    m = cell.config["model"]
    eng_cfg = dict(cell.config["engine"])
    serve = cell.serve
    traffic = Traffic(cell.traffic, seed, eng_cfg["token_ids"])
    cfg = getattr(cell.arch, "port_config", model_config)(m)
    free = None if "num_pages" in eng_cfg \
        else torch.cuda.mem_get_info(dev)[0]
    num_pages = pool_pages(m, eng_cfg, free, cell.arch)
    engine = InferenceEngine(
        cfg, seed=seed, max_batch=int(serve["max_batch"]),
        page_size=int(eng_cfg["page_size"]), num_pages=num_pages,
        max_seq_len=int(eng_cfg["max_seq_len"]), device=dev)
    t0 = time.perf_counter()
    engine.model.to_empty(device=dev)
    W.fill_layout(engine.model.named_parameters(), cell.arch.layout(m),
                  seed)
    engine.load(engine.model.state_dict())
    t1 = time.perf_counter()
    if warm:
        _warm_up(engine, traffic, serve, seed)
    if traffic.spec.get("warm_shared"):
        for h in [engine.submit(p, max_new_tokens=1, temperature=0.0)
                  for p in traffic.shared_prompts()]:
            h.result()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"weights {t1 - t0:.3f} s, warm-up {time.perf_counter() - t1:.3f} s")
    return Setup(cell, m, eng_cfg, traffic, engine, cfg.name, num_pages, dev,
                 bench.loop(traffic.loop))


def drive(s: Setup, seconds: float, tracer: Optional[Tracer] = None):
    """The window.  Returns it and the engine's counters over it."""
    engine = s.engine
    before = engine.stats.as_dict()
    after: Dict[str, float] = {}

    def opened():
        if tracer is not None:
            tracer.start()

    def closed():
        after.update(engine.stats.as_dict())
        if tracer is not None:
            tracer.stop()

    win = s.loop(engine, s.traffic, seconds, on_open=opened, on_close=closed)
    stats = {k: after[k] - before[k] for k in before
             if isinstance(before[k], (int, float))}
    return win, stats


def tear_down(s: Setup) -> int:
    """Read the card's peak memory, then stop and free the engine.
    Returns the peak in bytes."""
    dev = s.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
        log(f"peak {peak / _GIB:.3f} GiB, allocator retries {retries}")
    _stop(s.engine, s.name)
    s.engine = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return peak


class ForbiddenModules(RuntimeError):
    pass


def run(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> dict:
    s = set_up(bench, name, seed, device)
    tracer = Tracer(s.engine) if trace else None
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; {s.num_pages} pages of "
        f"{s.engine_cfg['page_size']}; window {seconds} s")
    win, stats = drive(s, seconds, tracer)
    bad = guard.forbidden()
    if bad:
        raise ForbiddenModules(
            f"modules of JAX or the JAX package loaded: {bad}")
    mem_peak = tear_down(s)
    t0 = time.perf_counter()
    data = RunData(s.cell, s.model, seconds, setup_s, win,
                   stats, int(s.engine_cfg["page_size"]),
                   tracer.reduce() if tracer is not None else None)
    t1 = time.perf_counter()
    checks = judge(data, seed, s.device, s.engine_cfg)
    log(f"trace read {t1 - t0:.3f} s, reference {time.perf_counter() - t1:.3f}"
        f" s; {len(win.records)} calls submitted")
    metrics = {}
    for spec in bench.metrics(name, trace):
        value = bench.reader(spec["name"])(data)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    counted = data.in_window()
    dev = s.device
    result = {
        "correct": correct(checks),
        "attempted": len(counted),
        "failed": sum(r.error is not None for r in counted),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": s.cell.chips,
            "memory_peak_bytes": int(mem_peak),
            "power_limit": power_limit() if dev.type == "cuda" else None,
        },
    }
    if data.trace is not None:
        result["device"]["busy_s"] = data.trace.busy_s
        result["device"]["window_s"] = data.trace.window_s
        result["breakdown"] = data.trace.breakdown()
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['rule']} {c['limit']}"
            f"{'' if c['pass'] else '  FAILED'}")
    return result


def judge(data: RunData, seed: int, dev: torch.device, eng_cfg: dict,
          control: bool = False):
    """Every number compared, with its limit and whether it holds.  With
    ``control``, also the same numbers with the fp8 control's token gaps
    in the port's place, judged by the same limits: ``(port, control)``."""
    lim = data.cell.serve["correct"]
    recs = data.window.records
    finished = [r for r in recs if r.tokens is not None]
    picked = check.sample(finished, seed, int(lim["reference_calls"]))
    seqs = [(r.call.prompt, r.tokens) for r in picked]
    got = check.served_gaps(
        data.model, seed, seqs, device=dev,
        quantum=int(eng_cfg["prefill_quantum"]), arch=data.cell.arch,
        control=control) \
        if picked else (([], []) if control else [])
    port, ctrl = got if control else (got, None)

    def verdict(gaps) -> Dict[str, dict]:
        out = {}

        def add(name, value, rule, limit):
            ok = value <= limit if rule == "<=" else value >= limit
            out[name] = {"value": value, "rule": rule, "limit": limit,
                         "pass": bool(ok)}

        add("compared_calls", len(picked), ">=", int(lim["reference_calls"]))
        add("failed_calls", sum(r.error is not None for r in recs), "<=", 0)
        add("wrong_lengths", sum(len(r.tokens) != r.call.max_new
                                 for r in finished), "<=", 0)
        if data.window.drained:
            add("lost_calls", sum(r.done is None for r in recs), "<=", 0)
        got = check.numbers(gaps)
        for name in ("logit_gap", "logit_gap_mean"):
            if name in lim:
                add(name, got[name], "<=", float(lim[name]))
        return out

    return (verdict(port), verdict(ctrl)) if control else verdict(port)


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["pass"] for c in checks.values())
