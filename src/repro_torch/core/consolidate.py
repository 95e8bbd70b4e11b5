"""Consolidation — a batch of queries over one or many templates → one graph.

Each template node becomes a MACRO-NODE carrying the per-query bindings
(DESIGN.md §8.1).  The optimizer plans macro-nodes (the DP state space
is independent of N); the Processor batches the bindings inside each
epoch.

Physical request counts are derived by BINDING-INFLUENCE propagation:
node v's output is a deterministic function of the binding parameters
appearing in its own template plus (transitively) in its ancestors'.
Two queries whose bindings agree on that influence set are guaranteed to
produce identical requests at v — so they coalesce.  For tool nodes with
binding-only args the rendered string itself is the signature (letting
DIFFERENT nodes that issue the same SQL share one physical execution).

``consolidate_multi`` extends this across templates (DESIGN.md §8.1):
a mixed batch — several (template, bindings) pairs — merges into ONE
mega-DAG whose node ids are namespaced per template (``t0/plan``,
``t1/gen``).  Binding influence propagates per template (the merged
graph is a disjoint union), but the signature space is shared, so two
DIFFERENT templates issuing the same rendered SQL coalesce into one
physical request, and LLM nodes with identical static prompts become
warm-KV aliases the cost model can credit across templates.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import (Dict, FrozenSet, List, Optional, Sequence, Set, Tuple)

from repro_torch.core.graphspec import GraphSpec, NodeSpec
from repro_torch.core.parser import static_signature

# upstream refs may carry a template namespace ("${t0/plan}"), hence "/"
_REF = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_/]*)\}")
_PARAM = re.compile(r"\$([A-Za-z_][A-Za-z0-9_]*)")


def _template_params(text: str, binding_keys: Set[str]) -> Set[str]:
    """$params used directly in a template (excluding ${upstream} refs)."""
    no_refs = _REF.sub("", text)
    return {p for p in _PARAM.findall(no_refs) if p in binding_keys}


def _influence_sets(template: GraphSpec,
                    binding_keys: Set[str]) -> Dict[str, Set[str]]:
    """Topological binding-influence propagation over one template."""
    influence: Dict[str, Set[str]] = {}
    for nid in template.topo_order():
        spec = template.nodes[nid]
        text = spec.prompt if spec.is_llm() else spec.args
        inf = _template_params(text, binding_keys)
        for p in template.parents(nid):
            inf |= influence[p]
        influence[nid] = inf
    return influence


def _node_signatures(spec: NodeSpec, sig_id: str,
                     influence_keys: Sequence[str],
                     bindings: Sequence[Dict[str, str]]
                     ) -> Tuple[List[str], List[int]]:
    """(unique signatures, per-query signature index) for one macro node.

    ``sig_id`` is the template-LOCAL node id (multi-template
    consolidation namespaces the graph ids but keeps signatures in the
    base id space so the same template submitted twice produces
    comparable signatures), optionally suffixed ``@<lineage digest>`` by
    the multi consolidator so nodes whose upstream subtrees differ can
    never share an upstream-dependent signature.
    """
    text = spec.prompt if spec.is_llm() else spec.args
    has_refs = bool(_REF.search(text))
    # spec identity disambiguates COLLIDING local ids across templates
    # (same "t" node in two unrelated templates must not merge) while
    # staying equal for two copies of the same template
    ident = f"{sig_id}|{spec.op}|{spec.model}|{text}"
    sig_ix: Dict[str, int] = {}
    uniq: List[str] = []
    of_query: List[int] = []
    for b in bindings:
        if has_refs or spec.is_llm():
            # upstream-dependent: influence-tuple signature
            s = ident + "||" + "|".join(str(b.get(k, ""))
                                        for k in influence_keys)
        else:
            # binding-only tool args: the rendered string itself —
            # different nodes issuing identical requests coalesce
            s = spec.op + "|" + static_signature(text, b)
        if s not in sig_ix:
            sig_ix[s] = len(uniq)
            uniq.append(s)
        of_query.append(sig_ix[s])
    return uniq, of_query


def _namespace_spec(spec: NodeSpec, id_map: Dict[str, str]) -> NodeSpec:
    """Rewrite a NodeSpec into the merged-graph namespace: its own id and
    every ``${upstream}`` ref it mentions get the template prefix."""
    def _sub(m: re.Match) -> str:
        return "${" + id_map.get(m.group(1), m.group(1)) + "}"

    return spec.with_(id=id_map[spec.id],
                      prompt=_REF.sub(_sub, spec.prompt),
                      args=_REF.sub(_sub, spec.args))


@dataclass
class MacroNode:
    """One template node × its queries' bindings (a planning unit)."""

    spec: NodeSpec
    bindings: List[Dict[str, str]]
    # influence set: binding params that (transitively) shape this node
    influence: FrozenSet[str] = frozenset()
    # distinct physical request signatures + per-query mapping
    unique_signatures: List[str] = field(default_factory=list)
    signature_of_query: List[int] = field(default_factory=list)
    # provenance: which template this node came from + the GLOBAL query
    # indices it serves (single-template: all of them)
    template: int = 0
    queries: Tuple[int, ...] = ()

    @property
    def n_logical(self) -> int:
        """Logical request count (one per query of this node's template)."""
        return len(self.bindings)

    @property
    def n_unique(self) -> int:
        """Distinct request signatures within this macro node."""
        return len(self.unique_signatures)


class ConsolidatedGraph:
    """Template GraphSpec × N bindings, with per-node macro views."""

    def __init__(self, template: GraphSpec,
                 bindings: Sequence[Dict[str, str]]):
        self.template = template
        self.bindings = [dict(b) for b in bindings]
        self.template_names = [template.name]
        self.template_of: Dict[str, int] = {nid: 0 for nid in template.nodes}
        keys: Set[str] = set()
        for b in self.bindings:
            keys |= set(b)
        influence = _influence_sets(template, keys)
        qs = tuple(range(len(self.bindings)))
        self.macros: Dict[str, MacroNode] = {}
        for nid, spec in template.nodes.items():
            uniq, of_query = _node_signatures(
                spec, nid, sorted(influence[nid]), self.bindings)
            self.macros[nid] = MacroNode(
                spec=spec, bindings=self.bindings,
                influence=frozenset(influence[nid]),
                unique_signatures=uniq, signature_of_query=of_query,
                template=0, queries=qs)

    # ------------------------------------------------------------------
    @property
    def n_queries(self) -> int:
        """Total queries across every template in the batch."""
        return len(self.bindings)

    @property
    def n_templates(self) -> int:
        """How many templates were consolidated (1 unless multi)."""
        return len(self.template_names)

    def macro(self, nid: str) -> MacroNode:
        """The macro-node view of template node ``nid``."""
        return self.macros[nid]

    def queries_map(self) -> Optional[Dict[str, List[int]]]:
        """Per-node global query indices, or None when every node serves
        every query (the single-template case — BatchState's default)."""
        return None

    def physical_signatures(self, nid: str) -> List[str]:
        """Signatures ``nid`` must physically execute.  Multi-template
        consolidation removes signatures another template's node already
        owns; single-template keeps every unique signature."""
        return list(self.macros[nid].unique_signatures)

    def warm_aliases(self) -> Dict[str, Tuple[str, ...]]:
        """LLM nodes whose warm KV is interchangeable with ``nid``'s
        (identical static prompts across templates); empty for single."""
        return {}

    def static_dedup_ratio(self, nid: str) -> float:
        """unique / logical — 1.0 means no cross-query redundancy.

        A macro-node can end up with ``n_logical == 0`` (a template
        submitted with an empty binding list, or every request merged
        away by cross-template consolidation): that is "no redundancy",
        not infinite dedup, so the ratio pins to 1.0 instead of
        dividing by zero.
        """
        m = self.macros[nid]
        if m.n_logical == 0:
            return 1.0
        return m.n_unique / m.n_logical

    def coalescing_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-node logical/unique/physical counts + guarded dedup ratio."""
        return {nid: {"logical": m.n_logical, "unique": m.n_unique,
                      "physical": len(self.physical_signatures(nid)),
                      "dedup_ratio": round(self.static_dedup_ratio(nid), 6)}
                for nid, m in self.macros.items()}

    def batch_sizes(self, logical_tools: bool = False) -> Dict[str, int]:
        """Per-node request counts for the cost model: LLM nodes price
        their logical batch (every query decodes); tool nodes price only
        the physical executions left after coalescing (or the logical
        count when ``logical_tools`` — the no-coalescing A/B control)."""
        return {nid: (m.n_logical if (m.spec.is_llm() or logical_tools)
                      else len(self.physical_signatures(nid)))
                for nid, m in self.macros.items()}


class MultiConsolidatedGraph(ConsolidatedGraph):
    """Several (template, bindings) pairs merged into one mega-DAG.

    Node ids are namespaced ``t{k}/{id}`` (so colliding ids across
    templates stay distinct), upstream refs inside prompts/args are
    rewritten to the namespaced form, and the global binding list is the
    concatenation of the per-template lists — macro node ``t{k}/v``
    serves exactly template k's global query slice.

    Signatures stay in the base id space, so the shared signature table
    dedups ACROSS templates: the first node (in merged topo order) to
    issue a signature owns its physical execution; later nodes —
    including nodes of other templates — alias it.  LLM nodes with
    identical static specs become ``warm_aliases`` for the cost model's
    cross-template prefix credit.
    """

    def __init__(self, batches: Sequence[Tuple[GraphSpec,
                                               Sequence[Dict[str, str]]]]):
        batches = list(batches)
        if not batches:
            raise ValueError("consolidate_multi needs at least one batch")
        # persistent merge state: graft() appends to these and re-derives
        # the views, so a session can keep consolidating into one graph
        self._nodes: List[NodeSpec] = []
        self._edges: List[Tuple[str, str]] = []
        self.bindings = []            # identity is shared with the runtime
        self.template_names = []
        self.template_of = {}
        self.macros = {}
        self._alias_key: Dict[str, str] = {}  # nid -> lineage digest
        self._owner: Dict[str, str] = {}
        self._absorb(batches)

    def _absorb(self, batches: Sequence[Tuple[GraphSpec,
                                              Sequence[Dict[str, str]]]]
                ) -> List[str]:
        """Merge ``batches`` into the persistent state (initial build and
        every later graft) and return the newly added node ids.

        Template indices and query offsets continue where the last absorb
        stopped; ``self.bindings`` is EXTENDED in place (the running
        dispatcher/workers hold a reference to it); signature ownership
        uses ``setdefault`` over the full merged topo order, so an
        already-owned signature keeps its owner — a grafted node whose
        request an in-flight (or finished) node already issued aliases
        that execution instead of re-running it (DESIGN.md §10.2).
        """
        nodes: List[NodeSpec] = list(self._nodes)
        edges: List[Tuple[str, str]] = list(self._edges)
        new_ids: List[str] = []
        alias_key = self._alias_key
        offset = len(self.bindings)
        for k, (tmpl, binds) in enumerate(batches,
                                          start=len(self.template_names)):
            ns = f"t{k}/"
            binds = [dict(b) for b in binds]
            keys: Set[str] = set()
            for b in binds:
                keys |= set(b)
            influence = _influence_sets(tmpl, keys)
            id_map = {nid: ns + nid for nid in tmpl.nodes}
            qs = tuple(range(offset, offset + len(binds)))
            # structural lineage digest: the node's own spec (id-free)
            # chained over its parents' digests — equal ONLY when the
            # whole upstream subtree is identical, so "Summarize ${x}"
            # over different x-templates never aliases or dedups.
            # Chaining (not nesting) keeps this O(nodes) on fan-in
            # heavy templates where a materialized subtree key would
            # blow up exponentially.
            lineage_digest: Dict[str, str] = {}
            for nid in tmpl.topo_order():
                spec = tmpl.nodes[nid]
                # parent order is the template's edge order — identical
                # for two copies of the same template, which is all the
                # equality needs
                payload = repr((spec.with_(id=""),
                                tuple(lineage_digest[p]
                                      for p in tmpl.parents(nid))))
                lineage_digest[nid] = hashlib.blake2b(
                    payload.encode(), digest_size=8).hexdigest()
            for nid, spec in tmpl.nodes.items():
                nspec = _namespace_spec(spec, id_map)
                nodes.append(nspec)
                new_ids.append(nspec.id)
                self.template_of[nspec.id] = k
                # the lineage digest keys upstream-dependent signatures:
                # requests dedup across templates ONLY when the whole
                # subtree feeding them is identical (two copies of one
                # template share digests; colliding ids or same-text
                # nodes over different parents do not)
                uniq, of_query = _node_signatures(
                    spec, f"{nid}@{lineage_digest[nid]}",
                    sorted(influence[nid]), binds)
                self.macros[nspec.id] = MacroNode(
                    spec=nspec, bindings=binds,
                    influence=frozenset(influence[nid]),
                    unique_signatures=uniq, signature_of_query=of_query,
                    template=k, queries=qs)
                if spec.is_llm():
                    # identity in the ORIGINAL template space: the whole
                    # upstream subtree must match for two nodes' warm KV
                    # to be interchangeable at the engine's radix tree
                    alias_key[nspec.id] = lineage_digest[nid]
            edges.extend((ns + u, ns + v) for u, v in tmpl.edges)
            self.template_names.append(tmpl.name)
            self.bindings.extend(binds)
            offset += len(binds)
        self._nodes, self._edges = nodes, edges
        self.template = GraphSpec(
            "multi(" + "+".join(self.template_names) + ")", nodes, edges)

        # ---- cross-template signature ownership (tool dedup) ------------
        # first issuer in merged topo order owns the physical execution;
        # setdefault never re-keys an existing signature, so grafts can't
        # move ownership off a node that may already have executed
        for nid in self.template.topo_order():
            m = self.macros[nid]
            if m.spec.is_llm():
                continue
            for s in m.unique_signatures:
                self._owner.setdefault(s, nid)

        # ---- warm-KV aliases across templates (LLM radix sharing) -------
        groups: Dict[str, List[str]] = {}
        for nid, key in alias_key.items():
            groups.setdefault(key, []).append(nid)
        self._aliases: Dict[str, Tuple[str, ...]] = {}
        for members in groups.values():
            if len(members) < 2:
                continue
            for nid in members:
                self._aliases[nid] = tuple(x for x in members if x != nid)
        return new_ids

    # ------------------------------------------------------------------
    def graft(self, batches: Sequence[Tuple[GraphSpec,
                                            Sequence[Dict[str, str]]]]
              ) -> Tuple[List[str], int]:
        """Incrementally consolidate ``batches`` into this mega-DAG
        (DESIGN.md §10.2).

        Returns ``(new_node_ids, query_offset)``: the namespaced ids the
        graft added and the global index of its first query.  The grafted
        nodes join the EXISTING signature table (a request an in-flight
        node already issued is aliased, not re-executed) and the existing
        warm-alias groups (the engine's radix tree shares their pages),
        which is what lets a query arriving mid-run ride on the running
        batch's work instead of waiting for the next one.
        """
        batches = list(batches)
        if not batches:
            raise ValueError("graft needs at least one batch")
        query_offset = len(self.bindings)
        new_ids = self._absorb(batches)
        return new_ids, query_offset

    # ------------------------------------------------------------------
    def queries_map(self) -> Optional[Dict[str, List[int]]]:
        """Each namespaced node serves only its own template's slice."""
        return {nid: list(m.queries) for nid, m in self.macros.items()}

    def physical_signatures(self, nid: str) -> List[str]:
        """Signatures ``nid`` owns — the rest ride on another template's
        (or an earlier node's) physical execution."""
        m = self.macros[nid]
        if m.spec.is_llm():
            return list(m.unique_signatures)
        return [s for s in m.unique_signatures if self._owner[s] == nid]

    def warm_aliases(self) -> Dict[str, Tuple[str, ...]]:
        """nid → other LLM nodes with the identical static spec."""
        return dict(self._aliases)

    def cross_template_summary(self) -> Dict[str, float]:
        """How much the mega-DAG coalesced ACROSS template boundaries."""
        sig_templates: Dict[str, Set[int]] = {}
        tool_unique = tool_physical = cross_deduped = 0
        for nid, m in self.macros.items():
            if m.spec.is_llm():
                continue
            tool_unique += m.n_unique
            owned = 0
            for s in m.unique_signatures:
                sig_templates.setdefault(s, set()).add(m.template)
                own = self._owner[s]
                if own == nid:
                    owned += 1
                elif self.macros[own].template != m.template:
                    cross_deduped += 1
            tool_physical += owned
        merged = sum(1 for ts in sig_templates.values() if len(ts) >= 2)
        return {
            "templates": self.n_templates,
            "tool_unique": tool_unique,
            "tool_physical": tool_physical,
            "deduped_requests": tool_unique - tool_physical,
            "cross_template_deduped": cross_deduped,
            "merged_signatures": merged,
            "llm_alias_nodes": len(self._aliases),
        }


def consolidate(template: GraphSpec,
                bindings: Sequence[Dict[str, str]]) -> ConsolidatedGraph:
    """One template × N bindings → one consolidated graph."""
    return ConsolidatedGraph(template, bindings)


def consolidate_multi(batches: Sequence[Tuple[GraphSpec,
                                              Sequence[Dict[str, str]]]]
                      ) -> MultiConsolidatedGraph:
    """Many (template, bindings) pairs → one consolidated mega-DAG.

    The merged graph namespaces node ids per template and shares one
    signature table, so redundant requests coalesce across templates and
    the epoch DP can interleave heterogeneous macro-nodes in one epoch
    (DESIGN.md §8.1).
    """
    return MultiConsolidatedGraph(batches)
