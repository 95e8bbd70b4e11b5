"""Cross-worker KV-cache migration (paper §5: the Processor's
"KV-cache sharing and **migration**"; DESIGN.md §7.3).

Prefix sharing keeps a node's warm KV useful only on the worker that
computed it.  When a mid-run replan splices a node onto a DIFFERENT
worker, its warm parent-lineage pages would strand on the old host and
the new host would re-prefill the whole prompt from scratch — replanning
would tax locality exactly where it should pay.  ``KVMigrator`` closes
that gap:

* on every plan splice it diffs the per-worker assignments (old board
  sequences vs the new tail) and, for each moved LLM node, looks up the
  prompts that node — and its LLM parents, the lineage the cost model's
  warm credit refers to — last ran with on the source host;
* each prompt's warm prefix is probed on the source engine, the
  migrate-vs-recompute decision is priced with the cost model's roofline
  (transfer over the modeled worker↔worker link vs re-prefilling the
  same tokens), and winners are exported (contiguous KV copy) and
  imported into the destination engine, which stamps its radix tree so
  the node's first admission wave aliases the pages;
* transfers are priced at ``link_bandwidth`` and accounted on the
  engines (``pages_migrated_in/out``, ``migrate_seconds``) and on the
  migrator itself for RunReport surfacing.

Migration runs BEFORE ``PlanBoard.splice`` publishes the new tail, so a
moved node's first wave on the new worker already sees the warm pages.
It is strictly best-effort and semantics-free: imported pages are just
extra warm donors, and temperature-0 outputs are bitwise-identical with
migration on, off, or forced (asserted in tests).

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModel
from repro_torch.core.graphspec import GraphSpec
from repro_torch.debugsync import named_lock


class KVMigrator:
    """Moves warm KV prefixes between EngineHosts when a splice moves
    their nodes."""

    def __init__(self, graph: GraphSpec, hosts: Sequence,
                 cost_model: Optional[CostModel] = None,
                 link_bandwidth: Optional[float] = None):
        self.graph = graph                       # swap-only
        self.hosts = list(hosts)
        self.cm = cost_model
        # the wire model pricing migrate_seconds MUST be the same link
        # the cost model's migrate-vs-recompute decision assumed, or the
        # accounted transfer time can exceed the re-prefill time the
        # decision claimed to beat
        if link_bandwidth is None:
            link_bandwidth = (cost_model.hw.link_bw
                              if cost_model is not None else 16e9)
        self.link_bandwidth = link_bandwidth     # bytes/s
        # serializes the outcome counters: splice-time migration (the
        # monitor thread) and claim-time pulls (worker threads) overlap
        self.lock = named_lock("KVMigrator.lock")
        # outcomes (RunReport surfacing): assignment changes seen, moves
        # with >=1 prefix sent, modeled link-transfer seconds, transfers
        # lost to re-prefill, best-effort failures swallowed
        self.nodes_moved = 0                    # guarded-by: self.lock
        self.nodes_migrated = 0                 # guarded-by: self.lock
        self.prefixes_migrated = 0              # guarded-by: self.lock
        self.pages_migrated = 0                 # guarded-by: self.lock
        self.tokens_migrated = 0                # guarded-by: self.lock
        self.migrate_seconds = 0.0              # guarded-by: self.lock
        self.skipped_recompute = 0              # guarded-by: self.lock
        self.transfer_errors = 0                # guarded-by: self.lock

    # ------------------------------------------------------------------
    def assignment_diff(self, board, tail) -> List[Tuple[str, int, int]]:
        """(node, old_worker, new_worker) for every still-unclaimed node
        the new tail places on a different worker than the live board."""
        old = board.planned_assignments()
        moves = []
        for w, seq in enumerate(tail.worker_sequences(board.W)):
            for n in seq:
                if n in old and old[n] != w:
                    moves.append((n, old[n], w))
        return sorted(moves)

    def migrate_for_splice(self, board, tail) -> int:
        """Migrate warm lineage prefixes for the nodes ``tail`` places.

        Every still-unclaimed node is considered, not just the ones the
        splice MOVES: the solver's peer-context credit prices a warm
        lineage held on any other worker, so realizing it only for
        assignment changes would leave the unmoved-but-remote-warm case
        as phantom savings.  The node's previous worker is tried first
        (that is where a move strands the warmest data), then the rest.
        Returns the number of prefixes transferred."""
        old = board.planned_assignments()
        total = 0
        for dst_w, seq in enumerate(tail.worker_sequences(board.W)):
            for nid in seq:
                if nid not in old:               # claimed meanwhile
                    continue
                if old[nid] != dst_w:
                    with self.lock:
                        self.nodes_moved += 1
                sources = [old[nid]] if old[nid] != dst_w else []
                sources += [w for w in range(board.W)
                            if w != dst_w and w not in sources]
                total += self._migrate_node(nid, sources, dst_w)
        return total

    # ------------------------------------------------------------------
    def migrate_node_from_peers(self, nid: str, dst_w: int) -> int:
        """Pull ``nid``'s warm lineage from every OTHER worker right
        before its first wave runs on ``dst_w``.

        This is the claim-time realization of the cost model's peer
        credit: splice-time migration only sees KV that existed when the
        splice fired, but a parent that completes afterwards (or a plan
        that never drifts at all) still leaves warm lineage on peers —
        the worker pulls it here, so the solver's priced savings
        materialize for unmoved nodes too."""
        sources = [w for w in range(len(self.hosts)) if w != dst_w]
        return self._migrate_node(nid, sources, dst_w)

    def _alias_ids(self, nid: str) -> Sequence[str]:
        """Cross-template warm aliases of ``nid`` (multi-template mega-
        DAGs): nodes whose identical upstream subtree makes their warm
        KV interchangeable with ``nid``'s.  The cost model prices these
        as donors, so the migrator must probe them too or the planner's
        credit would be savings execution never realizes."""
        if self.cm is None:
            return ()
        return self.cm.warm_aliases.get(nid, ())

    def _lineage_prompts(self, nid: str, host) -> List[tuple]:
        """Recent prompts of ``nid`` / its LLM parents / their warm
        aliases on ``host`` — the node's warm lineage, newest first,
        deduplicated."""
        cand: List[tuple] = list(host.prompts_for(nid))
        for a in self._alias_ids(nid):
            cand.extend(host.prompts_for(a))
        for p in self.graph.parents(nid):
            if self.graph.nodes[p].is_llm():
                cand.extend(host.prompts_for(p))
                for a in self._alias_ids(p):
                    cand.extend(host.prompts_for(a))
        seen: set = set()
        out: List[tuple] = []
        for prompt in reversed(cand):            # newest first
            if prompt not in seen:
                seen.add(prompt)
                out.append(prompt)
        return out

    def _migrate_node(self, nid: str, src_workers: Sequence[int],
                      dst_w: int) -> int:
        """Best-effort by contract: every per-prefix failure (step-gap
        timeout, pool pressure, eviction races) is swallowed and counted
        — a migration problem must never fail the batch it was trying
        to speed up."""
        spec = self.graph.nodes[nid]
        sent = 0
        for src_w in src_workers:
            src = self.hosts[src_w].peek_engine(spec.model)
            if src is None:                      # model never ran there
                continue
            for prompt in self._lineage_prompts(nid, self.hosts[src_w]):
                try:
                    sent += self._migrate_prefix(spec, src, dst_w, prompt)
                except Exception:
                    with self.lock:
                        self.transfer_errors += 1
        if sent:
            with self.lock:
                self.nodes_migrated += 1
        return sent

    def _migrate_prefix(self, spec, src, dst_w: int, prompt: tuple) -> int:
        depth = src.probe_prefix(prompt)
        if depth <= 0:
            return 0
        if self.cm is not None and spec.model in self.cm.models \
                and not self.cm.migration_wins(spec, depth):
            with self.lock:
                self.skipped_recompute += 1
            return 0
        dst = self.hosts[dst_w].engine_for_import(spec.model)
        if dst.probe_prefix(prompt) >= depth:
            return 0                             # destination already warm
        exported = src.export_prefix(prompt)
        if exported is None:
            return 0                             # evicted since the probe
        tokens, k, v = exported
        if self.cm is not None and spec.model in self.cm.models:
            # the SAME wire model the migrate-vs-recompute decision
            # used — accounted seconds must not contradict it
            seconds = self.cm.t_migrate(spec, len(tokens))
        else:
            seconds = (k.nbytes + v.nbytes) / self.link_bandwidth
        pages = dst.import_prefix(tokens, k, v, migrate_seconds=seconds)
        if not pages:
            return 0
        # out-counter on CONFIRMED import only, so in/out track real
        # transfers symmetrically
        src.stats.pages_migrated_out += pages
        with self.lock:
            self.prefixes_migrated += 1
            self.pages_migrated += pages
            self.tokens_migrated += len(tokens)
            self.migrate_seconds += seconds
        return 1

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        with self.lock:
            return {
                "nodes_moved": self.nodes_moved,
                "nodes_migrated": self.nodes_migrated,
                "prefixes_migrated": self.prefixes_migrated,
                "pages_migrated": self.pages_migrated,
                "tokens_migrated": self.tokens_migrated,
                "migrate_seconds": round(self.migrate_seconds, 9),
                "skipped_recompute": self.skipped_recompute,
                "transfer_errors": self.transfer_errors,
            }
