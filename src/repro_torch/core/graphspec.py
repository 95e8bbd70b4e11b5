"""GraphSpec — the typed workflow-DAG IR (paper §3, Parser output).

Nodes are either LLM invocations (GPU-resident) or tool calls
(CPU-resident: SQL / HTTP / local functions).  Edges carry data or
control dependencies.  The optimizer plans over the LLM-only projection
``llm_dag()`` (paper §4); tool nodes enter the cost model through
``T_prep``.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple


class NodeType(str, enum.Enum):
    """Whether a node runs on a GPU worker (LLM) or the CPU pool (TOOL)."""

    LLM = "llm"
    TOOL = "tool"


@dataclass(frozen=True)
class NodeSpec:
    """One workflow node: an LLM invocation or a tool call template."""

    id: str
    type: NodeType
    # --- LLM nodes -----------------------------------------------------
    model: str = ""                    # model id, e.g. "qwen3-14b"
    prompt: str = ""                   # template; $param / ${upstream_id}
    max_new_tokens: int = 32           # unit: tokens
    temperature: float = 0.0
    # --- tool nodes ------------------------------------------------------
    op: str = ""                       # "sql" | "http" | "pyfn"
    args: str = ""                     # template; $param / ${upstream_id}
    # ---------------------------------------------------------------------
    # static estimate hints (overridden by the online profiler)
    est_prompt_tokens: int = 64        # unit: tokens
    est_seconds: float = 0.0           # unit: s

    def is_llm(self) -> bool:
        """True for GPU-resident LLM nodes, False for CPU tool nodes."""
        return self.type == NodeType.LLM

    def with_(self, **kw) -> "NodeSpec":
        """A copy of this spec with the given fields replaced."""
        return replace(self, **kw)


class GraphSpec:
    """Validated DAG of NodeSpecs."""

    def __init__(self, name: str, nodes: Sequence[NodeSpec],
                 edges: Iterable[Tuple[str, str]]):
        self.name = name
        self.nodes: Dict[str, NodeSpec] = {}
        for n in nodes:
            if n.id in self.nodes:
                raise ValueError(f"duplicate node id {n.id!r}")
            self.nodes[n.id] = n
        self.edges: List[Tuple[str, str]] = []
        self._parents: Dict[str, List[str]] = {i: [] for i in self.nodes}
        self._children: Dict[str, List[str]] = {i: [] for i in self.nodes}
        for u, v in edges:
            if u not in self.nodes or v not in self.nodes:
                raise ValueError(f"edge ({u!r},{v!r}) references unknown node")
            if (u, v) in self.edges:
                continue
            self.edges.append((u, v))
            self._parents[v].append(u)
            self._children[u].append(v)
        self._topo = self._toposort()          # raises on cycles

    # ------------------------------------------------------------------
    def _toposort(self) -> List[str]:
        indeg = {i: len(self._parents[i]) for i in self.nodes}
        stack = sorted([i for i, d in indeg.items() if d == 0])
        out: List[str] = []
        while stack:
            v = stack.pop(0)
            out.append(v)
            for c in self._children[v]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
            stack.sort()                        # deterministic order
        if len(out) != len(self.nodes):
            raise ValueError(f"workflow {self.name!r} has a cycle")
        return out

    # ------------------------------------------------------------------
    def parents(self, v: str) -> List[str]:
        """Direct predecessors of ``v``."""
        return list(self._parents[v])

    def children(self, v: str) -> List[str]:
        """Direct successors of ``v``."""
        return list(self._children[v])

    def topo_order(self) -> List[str]:
        """All node ids in a deterministic topological order."""
        return list(self._topo)

    def llm_nodes(self) -> List[str]:
        """LLM node ids in topological order."""
        return [i for i in self._topo if self.nodes[i].is_llm()]

    def tool_nodes(self) -> List[str]:
        """Tool node ids in topological order."""
        return [i for i in self._topo if not self.nodes[i].is_llm()]

    def ancestors(self, v: str) -> FrozenSet[str]:
        """Every transitive predecessor of ``v``."""
        seen: set = set()
        stack = list(self._parents[v])
        while stack:
            u = stack.pop()
            if u not in seen:
                seen.add(u)
                stack.extend(self._parents[u])
        return frozenset(seen)

    # ------------------------------------------------------------------
    def llm_dag(self) -> "LLMDag":
        """Projection onto LLM nodes: edge u→v iff a path u⇝v exists using
        only tool nodes in between (the G_LLM of paper §4)."""
        llm = set(self.llm_nodes())
        edges: set = set()
        for src in llm:
            # BFS through tool nodes
            stack = list(self._children[src])
            seen: set = set()
            while stack:
                x = stack.pop()
                if x in seen:
                    continue
                seen.add(x)
                if x in llm:
                    edges.add((src, x))
                else:
                    stack.extend(self._children[x])
        return LLMDag(self, sorted(llm), sorted(edges))

    def tool_ancestors_between(self, v: str) -> List[str]:
        """Tool nodes on paths into LLM node v that do not cross another
        LLM node (the preparation set charged to T_prep(v))."""
        out: List[str] = []
        seen: set = set()
        stack = list(self._parents[v])
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            if not self.nodes[u].is_llm():
                out.append(u)
                stack.extend(self._parents[u])
        return sorted(out, key=self._topo.index)


class LLMDag:
    """The optimizer's view: LLM nodes only, with precedence edges."""

    def __init__(self, graph: GraphSpec, nodes: List[str],
                 edges: List[Tuple[str, str]]):
        self.graph = graph
        self.node_ids = list(nodes)
        self.edges = list(edges)
        self._parents: Dict[str, List[str]] = {i: [] for i in nodes}
        self._children: Dict[str, List[str]] = {i: [] for i in nodes}
        for u, v in edges:
            self._parents[v].append(u)
            self._children[u].append(v)

    def spec(self, v: str) -> NodeSpec:
        """The underlying NodeSpec of LLM node ``v``."""
        return self.graph.nodes[v]

    def parents(self, v: str) -> List[str]:
        """LLM-DAG predecessors of ``v``."""
        return list(self._parents[v])

    def children(self, v: str) -> List[str]:
        """LLM-DAG successors of ``v``."""
        return list(self._children[v])

    def frontier(self, done: FrozenSet[str]) -> List[str]:
        """Topological ready set: LLM preds all completed."""
        return [v for v in self.node_ids
                if v not in done and all(p in done for p in self._parents[v])]

    def is_valid_cut(self, done: FrozenSet[str], batch: FrozenSet[str]) -> bool:
        """Every LLM pred of each batch node is in done or in the batch."""
        return all(all(p in done or p in batch for p in self._parents[v])
                   for v in batch)

    def components(self, batch: FrozenSet[str]) -> List[List[str]]:
        """Weakly-connected components of the batch subgraph, each in topo
        order — the chains executed sequentially on one worker."""
        topo = [v for v in self.graph.topo_order() if v in batch]
        parent: Dict[str, str] = {v: v for v in batch}

        def _find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for u, v in self.edges:
            if u in batch and v in batch:
                parent[_find(u)] = _find(v)
        groups: Dict[str, List[str]] = {}
        for v in topo:
            groups.setdefault(_find(v), []).append(v)
        return list(groups.values())
