"""State-aware cost model  T(w,v,S) = T_prep + T_model + T_infer
(paper §4.1; DESIGN.md §8.2).

All GPU terms are ROOFLINE-DERIVED from hardware profiles rather than
magic constants:

* prefill is compute-bound:   t = 2 · P_active · tokens / (FLOPs · MFU)
* decode is bandwidth-bound:  t/step = (param_bytes + Σ KV bytes) / HBM_bw
  — which is precisely why continuous batching pays: the param-read term
  amortizes over the batch.
* model switch is host→HBM-bound: t = param_bytes / host_bw (+ eviction).
* the prefix-caching discount subtracts the matched warm-prefix tokens
  from effective prefill (whole-prefix only for recurrent-state archs,
  ``supports_partial_prefix=False``).

Tool terms come from the OperatorProfiler: an EXPLAIN-style estimate for
SQL (callable hook into the minidb), a signature-keyed moving average
for HTTP / local functions, continuously calibrated online.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.graphspec import GraphSpec, NodeSpec
from repro_torch.core.state import SystemState, WorkerContext


# ---------------------------------------------------------------------------
# hardware profiles
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareProfile:
    """Roofline description of one GPU/TPU worker class."""

    name: str
    flops: float                 # unit: flops/s (peak bf16 per worker)
    hbm_bw: float                # unit: bytes/s @hbm
    hbm_bytes: float             # unit: bytes
    host_bw: float               # unit: bytes/s @host (weight-loading path)
    mfu: float = 0.45            # unit: 1 (achieved fraction of peak, prefill)
    bw_eff: float = 0.75         # unit: 1 (achieved fraction of HBM bw, decode)
    dispatch_overhead: float = 0.030   # unit: s (per-epoch coordination)
    link_bw: float = 450e9       # unit: bytes/s @link (worker↔worker KV link)


H200 = HardwareProfile("h200", 989e12, 4.8e12, 141e9, 55e9, link_bw=900e9)
H100 = HardwareProfile("h100", 989e12, 3.35e12, 80e9, 55e9, link_bw=900e9)
A100 = HardwareProfile("a100", 312e12, 2.0e12, 80e9, 25e9, link_bw=600e9)
TPU_V5E = HardwareProfile("tpu_v5e", 197e12, 819e9, 16e9, 32e9,
                          link_bw=186e9)

HARDWARE = {h.name: h for h in (H200, H100, A100, TPU_V5E)}


# ---------------------------------------------------------------------------
# model profiles (the LLMs *served inside workflows*; paper: Qwen3-14B/32B,
# GPT-OSS-20B + light 0.4B–4B variants)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LLMProfile:
    """Served-model size/bandwidth profile the roofline terms price."""

    name: str
    param_bytes: float           # unit: bytes @weights (resident, bf16)
    active_param_count: float    # unit: flops/token (2 FLOPs per param-token)
    # dimensionally params ARE flops/token up to the roofline's pure-number
    # 2.0 scalar, which is why t_prefill's algebra closes without a cast
    kv_bytes_per_token: float    # unit: bytes/token @kv (2*L*Hkv*Dh*2)
    supports_partial_prefix: bool = True

    @staticmethod
    def from_params(name: str, n_params: float, n_layers: int,
                    kv_heads: int, head_dim: int,
                    active_params: Optional[float] = None,
                    supports_partial_prefix: bool = True) -> "LLMProfile":
        """Build a profile from parameter count + KV geometry (bf16)."""
        return LLMProfile(
            name=name,
            param_bytes=2.0 * n_params,
            active_param_count=active_params or n_params,
            kv_bytes_per_token=2.0 * n_layers * kv_heads * head_dim * 2,
            supports_partial_prefix=supports_partial_prefix)


# paper's serving models (sizes from the respective tech reports)
PAPER_MODELS = {
    "qwen3-14b": LLMProfile.from_params("qwen3-14b", 14.8e9, 40, 8, 128),
    "qwen3-32b": LLMProfile.from_params("qwen3-32b", 32.8e9, 64, 8, 128),
    "gpt-oss-20b": LLMProfile.from_params(         # MoE: 3.6B active
        "gpt-oss-20b", 20.9e9, 24, 8, 64, active_params=3.6e9),
    "qwen3-0.6b": LLMProfile.from_params("qwen3-0.6b", 0.6e9, 28, 8, 128),
    "qwen3-4b": LLMProfile.from_params("qwen3-4b", 4.0e9, 36, 8, 128),
    "qwq-32b": LLMProfile.from_params("qwq-32b", 32.8e9, 64, 8, 128),
    "deepseek-r1-distill-32b": LLMProfile.from_params(
        "deepseek-r1-distill-32b", 32.8e9, 64, 8, 128),
}


def profile_from_config(cfg) -> LLMProfile:
    """Build an LLMProfile from a repro ModelConfig (assigned archs)."""
    return LLMProfile(
        name=cfg.name,
        param_bytes=2.0 * cfg.param_count(),
        active_param_count=float(cfg.active_param_count()),
        kv_bytes_per_token=2.0 * cfg.num_layers * cfg.num_kv_heads
        * cfg.resolved_head_dim * 2,
        supports_partial_prefix=cfg.supports_partial_prefix)


# ---------------------------------------------------------------------------
# operator profiler (tools + calibration)
# ---------------------------------------------------------------------------

class OperatorProfiler:
    """Signature-keyed latency estimates with online calibration (EWMA)."""

    def __init__(self, explain_hook: Optional[Callable[[str], float]] = None,
                 alpha: float = 0.3):
        self.explain_hook = explain_hook    # sql text -> est seconds
        self.alpha = alpha
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    # unit: -> s
    def estimate(self, node: NodeSpec, rendered_args: str = "") -> float:
        """Expected seconds for one physical execution of ``node``."""
        key = f"{node.op}|{node.id}"
        if key in self._ewma:
            return self._ewma[key]
        if node.op == "sql" and self.explain_hook is not None:
            try:
                return self.explain_hook(rendered_args or node.args)
            except Exception:
                pass
        if node.est_seconds:
            return node.est_seconds
        return {"sql": 0.20, "http": 0.50, "pyfn": 0.05}.get(node.op, 0.10)

    def update(self, node_id: str, op: str, observed: float) -> None:
        """Fold one measured latency into the node's EWMA."""
        key = f"{op}|{node_id}"
        prev = self._ewma.get(key)
        self._ewma[key] = observed if prev is None else (
            self.alpha * observed + (1 - self.alpha) * prev)
        self._count[key] = self._count.get(key, 0) + 1

    @property
    def observations(self) -> int:
        """Total measured samples folded in so far."""
        return sum(self._count.values())

    def calibrated_keys(self) -> int:
        """How many distinct (op, node) keys have an online estimate."""
        return len(self._ewma)


class HardwareCalibration:
    """Fit the roofline's effective ``mfu``/``bw_eff`` knobs online.

    Only TOTAL node latency is observable, so this is a single
    time-scale fit: the ratio of predicted to observed latency rescales
    both knobs together (apportioning the total by predicted phase
    shares collapses to the same scalar, so the knobs stay correlated —
    decoupling them needs separately measured prefill/decode timings,
    a ROADMAP item).  An EWMA tracks the scale; ``profile()`` returns
    the base HardwareProfile with the calibrated knobs substituted —
    feed it back into a CostModel and predictions converge onto the
    machine actually running the batch.
    """

    def __init__(self, base: HardwareProfile, alpha: float = 0.5,
                 lo: float = 1e-4, hi: float = 10.0):
        self.base = base
        self.alpha = alpha
        self.lo, self.hi = lo, hi
        self.mfu = base.mfu
        self.bw_eff = base.bw_eff
        self.samples = 0

    def observe(self, t_prefill_pred: float, t_decode_pred: float,
                observed_s: float) -> None:
        """One (predicted prefill s, predicted decode s, measured s) sample.

        The predictions must come from a cost model currently using
        ``self.profile()`` (or ``base`` for the first sample) so the
        implied correction composes with prior calibration.
        """
        t_pred = t_prefill_pred + t_decode_pred
        if t_pred <= 0.0 or observed_s <= 0.0:
            return
        # single observable (total latency) -> single implied time-scale
        r = t_pred / observed_s            # <1: machine slower than modeled
        a = self.alpha
        self.mfu = (1 - a) * self.mfu + a * self._clip(self.mfu * r)
        self.bw_eff = (1 - a) * self.bw_eff + a * self._clip(self.bw_eff * r)
        self.samples += 1

    def _clip(self, x: float) -> float:
        return min(max(x, self.lo), self.hi)

    def profile(self) -> HardwareProfile:
        """The base profile with the calibrated knobs substituted."""
        return replace(self.base, mfu=self.mfu, bw_eff=self.bw_eff)

    def deltas(self) -> Dict[str, float]:
        """Calibrated-vs-static knob drift (for RunReport surfacing)."""
        return {
            "mfu_base": self.base.mfu, "mfu_eff": self.mfu,
            "bw_eff_base": self.base.bw_eff, "bw_eff_eff": self.bw_eff,
            "samples": self.samples,
        }


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@dataclass
class EpochWeights:
    """The epoch-blend weights (makespan-vs-load mix, overhead weight)."""

    mu: float = 0.7              # unit: 1 (makespan vs aggregate-load blend)
    lam: float = 1.0             # unit: 1 (per-epoch overhead weight)


class CostModel:
    """State-aware latency model T(w, v, S) shared by planner+runtime."""

    def __init__(self, graph: GraphSpec, hardware: HardwareProfile,
                 models: Dict[str, LLMProfile],
                 profiler: Optional[OperatorProfiler] = None,
                 weights: Optional[EpochWeights] = None,
                 batch_sizes: Optional[Dict[str, int]] = None,
                 avg_context_tokens: float = 256.0,
                 use_profiling: bool = True,
                 use_prep_guidance: bool = True,
                 cpu_parallelism: int = 16,
                 use_migration: bool = True,
                 warm_aliases: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.graph = graph
        self.hw = hardware
        self.models = models
        self.profiler = profiler or OperatorProfiler()
        # fresh instance per model: a module-level default would be shared
        # (and mutable) across every CostModel in the process
        self.weights = weights if weights is not None else EpochWeights()
        # physical batch size per LLM node (after coalescing); default 1
        self.batch_sizes = dict(batch_sizes or {})
        self.avg_context_tokens = avg_context_tokens  # unit: tokens
        self.use_profiling = use_profiling   # ablation: naive dep-count scoring
        self.use_prep_guidance = use_prep_guidance  # ablation: no T_prep term
        self.cpu_parallelism = cpu_parallelism
        # credit cross-worker KV migration (peer warm lineage) when the
        # executor actually migrates; False for non-migrating systems so
        # plans aren't priced with savings execution can't realize
        self.use_migration = use_migration
        # cross-template warm-KV equivalences (multi-template mega-DAGs,
        # DESIGN.md §8.1): node v's warm lineage also satisfies any alias
        # of v — two templates with the identical static prompt share one
        # radix lineage at the engine, so the planner credits either id
        self.warm_aliases = dict(warm_aliases or {})

    # ------------------------------------------------------------- T_model
    # unit: -> s
    def t_model(self, v: NodeSpec, ctx: WorkerContext) -> float:
        """Model-switch cost: load ``v``'s weights unless resident."""
        if ctx.model == v.model:
            return 0.0
        prof = self.models[v.model]
        load = prof.param_bytes / self.hw.host_bw
        evict = 0.1 * load if ctx.model else 0.0      # memory mgmt to admit
        return load + evict

    # ------------------------------------------------------------- T_infer
    def _batch(self, v: NodeSpec) -> int:
        return max(self.batch_sizes.get(v.id, 1), 1)

    def _alias_closure(self, parents: Sequence[str]) -> Sequence[str]:
        """Parents plus their cross-template warm-KV aliases — any of
        them being warm in a context makes that context a valid donor."""
        if not self.warm_aliases:
            return parents
        out = list(parents)
        for p in parents:
            out.extend(self.warm_aliases.get(p, ()))
        return out

    # unit: -> tokens
    def _warm_shared_tokens(self, v: NodeSpec, ctx: WorkerContext,
                            parents: Sequence[str]) -> float:
        """Prompt tokens a warm parent lineage in ``ctx`` would cover."""
        p = float(v.est_prompt_tokens)
        # donors: the node's parents, their aliases, and the node's OWN
        # aliases (an alias that already ran left this node's identical
        # static prompt warm in the radix tree)
        donors = list(self._alias_closure(parents))
        donors += list(self.warm_aliases.get(v.id, ()))
        if ctx.warm_parent(donors) is None:
            return 0.0
        prof = self.models[v.model]
        if not prof.supports_partial_prefix:
            # recurrent state: only whole-prefix snapshots reusable; credit
            # the snapshot only when the warm parent context covers the
            # whole prompt (prompt == parent context + nothing new)
            return p if self.avg_context_tokens >= p else 0.0
        return min(self.avg_context_tokens, 0.75 * p)

    # unit: tokens=tokens -> s
    def t_migrate(self, v: NodeSpec, tokens: float) -> float:
        """Modeled cost of shipping ``tokens`` worth of one sequence's KV
        over the worker↔worker link (paper §5: Processor "KV-cache …
        migration").  One transfer serves the whole macro-batch — the
        imported donor is page-aliased by every request — so this does
        NOT scale with batch size."""
        prof = self.models[v.model]
        return tokens * prof.kv_bytes_per_token / self.hw.link_bw

    # unit: -> tokens s
    def prefill_plan(self, v: NodeSpec, ctx: WorkerContext,
                     parents: Sequence[str],
                     peer_ctxs: Sequence[WorkerContext] = ()
                     ) -> Tuple[float, float]:
        """(effective prefill tokens, t_migrate) for ``v`` on a worker
        with context ``ctx`` while the OTHER workers hold ``peer_ctxs``.

        Local warm lineage is free (page aliasing).  Otherwise, a peer
        worker holding the warm parent lineage can migrate its prefix
        pages over the link: the credit is granted only when the source
        context is actually warm AND the modeled transfer beats
        re-prefilling the same tokens — the migrate-vs-recompute
        decision the runtime KVMigrator mirrors.  Recurrent-state archs
        (supports_partial_prefix=False) never migrate: their state rows
        are not paged KV.
        """
        p = float(v.est_prompt_tokens)
        local = self._warm_shared_tokens(v, ctx, parents)
        if local > 0.0:
            return p - local, 0.0
        prof = self.models[v.model]
        if not self.use_migration or not prof.supports_partial_prefix:
            return p, 0.0
        remote = max((self._warm_shared_tokens(v, c, parents)
                      for c in peer_ctxs), default=0.0)
        if remote > 0.0:
            t_mig = self.t_migrate(v, remote)
            t_saved = self._roofline_times(v, remote, self._batch(v))[0]
            if t_mig < t_saved:
                return p - remote, t_mig
        return p, 0.0

    # unit: -> tokens
    def effective_prefill_tokens(self, v: NodeSpec, ctx: WorkerContext,
                                 parents: Sequence[str],
                                 peer_ctxs: Sequence[WorkerContext] = ()
                                 ) -> float:
        """Prompt tokens left to prefill after every warm-KV discount."""
        return self.prefill_plan(v, ctx, parents, peer_ctxs)[0]

    # unit: tokens=tokens -> 1
    def migration_wins(self, v: NodeSpec, tokens: float,
                       batch: Optional[int] = None) -> bool:
        """True when migrating ``tokens`` of warm KV beats re-prefilling
        them — the runtime migrator's go/no-go check.  ``batch`` defaults
        to the node's planned batch size, the SAME n prefill_plan scales
        its savings by, so the runtime decision agrees with the credit
        the solver priced the placement with."""
        if tokens <= 0:
            return False
        prof = self.models[v.model]
        if not prof.supports_partial_prefix:
            return False
        n = batch if batch is not None else self._batch(v)
        t_saved = self._roofline_times(v, tokens, max(n, 1))[0]
        return self.t_migrate(v, tokens) < t_saved

    # unit: eff_p=tokens n=1 -> s s
    def _roofline_times(self, v: NodeSpec, eff_p: float, n: int
                        ) -> Tuple[float, float]:
        """(t_prefill, t_decode): the single source of the roofline
        formulas — both planning (t_infer) and online calibration
        (infer_breakdown) must price GPU work identically or the
        calibrated knobs decouple from the plans they steer."""
        prof = self.models[v.model]
        t_prefill = (2.0 * prof.active_param_count * eff_p * n
                     / (self.hw.flops * self.hw.mfu))
        # decode: each step reads the weights once + the batch's KV
        ctx_len = self.avg_context_tokens + v.est_prompt_tokens
        kv_read = n * prof.kv_bytes_per_token * ctx_len
        # the bytes above are read once per step, and a step emits one
        # token — so the quotient is a per-token time, not a total
        t_step = ((prof.param_bytes + kv_read)
                  / (self.hw.hbm_bw * self.hw.bw_eff))  # unit: s/token
        return t_prefill, v.max_new_tokens * t_step

    # unit: -> s s
    def infer_breakdown(self, v: NodeSpec,
                        batch: Optional[int] = None
                        ) -> Tuple[float, float]:
        """(t_prefill, t_decode) for a cold context — the two roofline
        phases the online HardwareCalibration fits its knobs from."""
        n = batch if batch is not None else self._batch(v)
        return self._roofline_times(v, float(v.est_prompt_tokens), n)

    # unit: -> s
    def t_infer(self, v: NodeSpec, ctx: WorkerContext,
                parents: Sequence[str],
                peer_ctxs: Sequence[WorkerContext] = ()) -> float:
        """Roofline prefill+decode (+migration) time for one macro-node."""
        n = self._batch(v)
        if not self.use_profiling:
            # ablation "w/o profiling scoring": score by dependency count
            return 0.05 * (1 + len(parents)) * n
        eff_p, t_mig = self.prefill_plan(v, ctx, parents, peer_ctxs)
        t_prefill, t_decode = self._roofline_times(v, eff_p, n)
        return t_prefill + t_decode + t_mig

    # -------------------------------------------------------------- T_prep
    # unit: -> s
    def t_prep(self, v: NodeSpec, done: frozenset) -> float:
        """Critical path of unmaterialized tool ancestors feeding v.

        Each pending tool macro-node runs its (coalesced) physical batch
        across the bounded CPU pool; chained tools add up (they are a
        sequential path into v).
        """
        if not self.use_prep_guidance:
            return 0.0
        tools = self.graph.tool_ancestors_between(v.id)
        pend = [t for t in tools if t not in done]
        t_total = 0.0
        for t_id in pend:
            spec = self.graph.nodes[t_id]
            n_phys = self.batch_sizes.get(t_id, 1)   # after coalescing
            waves = math.ceil(n_phys / self.cpu_parallelism)
            t_total += self.profiler.estimate(spec) * waves
        return t_total

    # ------------------------------------------------------------- T total
    # unit: -> s -
    def t_node(self, v_id: str, ctx: WorkerContext, done: frozenset,
               peer_ctxs: Sequence[WorkerContext] = ()
               ) -> Tuple[float, WorkerContext]:
        """Latency of one (macro-)node on a worker + the context after.

        ``peer_ctxs`` — the OTHER workers' contexts — lets the prefill
        term price a cross-worker KV migration when the parent lineage
        is warm elsewhere (see :meth:`prefill_plan`)."""
        v = self.graph.nodes[v_id]
        parents = self.graph.parents(v_id)
        t = (self.t_prep(v, done)
             + self.t_model(v, ctx)
             + self.t_infer(v, ctx, parents, peer_ctxs))
        return t, ctx.after(v_id, v.model)

    # ---------------------------------------------------------- epoch cost
    # unit: busy_values=s -> s
    def epoch_blend(self, busy_values: Sequence[float]) -> float:
        """The epoch scoring blend over per-worker busy times — shared by
        the solver's predictions AND the online drift monitor's observed
        costs: both must score identically or drift over/under-fires."""
        mu, lam = self.weights.mu, self.weights.lam
        return (mu * max(busy_values) + (1 - mu) * sum(busy_values)
                + lam * self.hw.dispatch_overhead)

    # unit: -> s - -
    def epoch_cost(self, components: Sequence[Sequence[str]],
                   workers: Sequence[int], state: SystemState
                   ) -> Tuple[float, Tuple[WorkerContext, ...], Dict[int, float]]:
        """Cost of launching ``components[i]`` on ``workers[i]``.

        Returns (C_epoch, next worker contexts, per-worker busy time).
        Chained nodes on one worker see the evolving context (model kept
        resident, parent lineage warm — the locality the DP rewards).
        """
        ctxs = list(state.contexts)
        t_w: Dict[int, float] = {}
        done = set(state.done)
        for comp, w in zip(components, workers):
            ctx = ctxs[w]
            # peers at EPOCH START: components run concurrently, so a
            # migration source is priced from the state the epoch opened
            # with, not from a sibling component's mid-epoch progress
            peers = tuple(c for x, c in enumerate(state.contexts) if x != w)
            busy = 0.0
            for v_id in comp:
                t, ctx = self.t_node(v_id, ctx, frozenset(done), peers)
                busy += t
                done.add(v_id)
            ctxs[w] = ctx
            t_w[w] = t_w.get(w, 0.0) + busy
        return self.epoch_blend(list(t_w.values())), tuple(ctxs), t_w
