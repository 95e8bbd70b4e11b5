"""Parser — declarative workflows → GraphSpec (paper §3).

The key transformation is *dependency decoupling*: tool calls embedded in
LLM prompts (``{{sql: SELECT ...}}``, ``{{http: GET ...}}``,
``{{fn: name(...)}}``) are extracted into standalone TOOL nodes so the
scheduler sees them as schedulable units rather than opaque side-effects.
The directive in the prompt is replaced by a ``${tool_node_id}``
placeholder and a tool→llm edge is added.

Input format: a plain dict (JSON-compatible; the YAML of the paper maps
1:1 onto this):

    {"name": "w1",
     "nodes": [
       {"id": "search", "type": "llm", "model": "qwen3-14b",
        "prompt": "Summarize {{sql: SELECT r FROM rev WHERE m='$market'}}",
        "max_new_tokens": 32},
       {"id": "edit", "type": "llm", "model": "qwen3-32b",
        "prompt": "Refine ${search} for $market"},
     ],
     "edges": [["search", "edit"]]}       # optional; ${refs} add implicit edges

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

from repro_torch.core.graphspec import GraphSpec, NodeSpec, NodeType

_DIRECTIVE = re.compile(r"\{\{\s*(sql|http|fn)\s*:\s*(.*?)\s*\}\}", re.S)
# upstream refs may be template-namespaced ("${t0/search}") by the
# multi-template consolidator (DESIGN.md §8.1), hence the "/"
_REF = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_/]*)\}")


def _decouple(node: dict) -> Tuple[dict, List[dict], List[Tuple[str, str]]]:
    """Extract embedded tool directives from one LLM node dict."""
    prompt = node.get("prompt", "")
    tools: List[dict] = []
    edges: List[Tuple[str, str]] = []
    idx = 0

    def _sub(m: re.Match) -> str:
        nonlocal idx
        tool_id = f"{node['id']}__{m.group(1)}{idx}"
        idx += 1
        tools.append({
            "id": tool_id, "type": "tool", "op": m.group(1),
            "args": m.group(2),
        })
        edges.append((tool_id, node["id"]))
        return "${" + tool_id + "}"

    new_prompt = _DIRECTIVE.sub(_sub, prompt)
    out = dict(node)
    out["prompt"] = new_prompt
    return out, tools, edges


def parse_workflow(spec: dict) -> GraphSpec:
    """Parse a declarative workflow dict into a validated GraphSpec."""
    name = spec.get("name", "workflow")
    raw_nodes: List[dict] = []
    edges: List[Tuple[str, str]] = [tuple(e) for e in spec.get("edges", [])]

    for nd in spec["nodes"]:
        if nd.get("type", "llm") == "llm":
            nd2, tools, tedges = _decouple(nd)
            raw_nodes.append(nd2)
            raw_nodes.extend(tools)
            edges.extend(tedges)
        else:
            raw_nodes.append(dict(nd))
        # explicit deps list
        for dep in nd.get("deps", []):
            edges.append((dep, nd["id"]))

    # implicit edges from ${node} references in prompts / args
    ids = {nd["id"] for nd in raw_nodes}
    for nd in raw_nodes:
        for text in (nd.get("prompt", ""), nd.get("args", "")):
            for ref in _REF.findall(text):
                if ref in ids and ref != nd["id"]:
                    edges.append((ref, nd["id"]))

    nodes = []
    for nd in raw_nodes:
        ntype = NodeType(nd.get("type", "llm"))
        nodes.append(NodeSpec(
            id=nd["id"], type=ntype,
            model=nd.get("model", ""),
            prompt=nd.get("prompt", ""),
            max_new_tokens=int(nd.get("max_new_tokens", 32)),
            temperature=float(nd.get("temperature", 0.0)),
            op=nd.get("op", ""),
            args=nd.get("args", ""),
            est_prompt_tokens=int(nd.get("est_prompt_tokens", 64)),
            est_seconds=float(nd.get("est_seconds", 0.0)),
        ))
    # dedupe edges, keep deterministic order
    seen = set()
    uniq_edges = []
    for e in edges:
        if e not in seen:
            seen.add(e)
            uniq_edges.append(e)
    return GraphSpec(name, nodes, uniq_edges)


def render(template: str, binding: Dict[str, str],
           upstream: Dict[str, str]) -> str:
    """Instantiate a prompt/args template with binding params ($param)
    and upstream results (${node_id})."""
    def _ref_sub(m: re.Match) -> str:
        return upstream.get(m.group(1), m.group(0))

    out = _REF.sub(_ref_sub, template)
    # longest-first so $market_id wins over $market
    for key in sorted(binding, key=len, reverse=True):
        out = out.replace("$" + key, str(binding[key]))
    return out


def static_signature(template: str, binding: Dict[str, str]) -> str:
    """Template rendered with bindings only (upstream refs left symbolic) —
    used for STATIC coalescing before execution."""
    return render(template, binding, {})
