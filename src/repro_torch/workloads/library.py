"""W1–W6 + W+ workflow library (Table 3 topologies).

Node counts match the paper exactly — #Nodes (LLM/CPU):
  W1 IMDb-Diamond 8/9 · W2 IMDb-TripleChain 10/3 · W3 FineWiki-LongChain 9/6
  W4 FineWiki-Bridge 9/3 · W5 TPCH-Trident 7/9 · W6 TPCH-Fanout 9/12
  W+ linear LLM-only chain 3/0.

Each builder returns (workflow dict, binding sampler).  Binding pools are
deliberately small relative to N so batches carry the cross-query
redundancy (repeated SQL templates, identical API calls) that Halo's
request coalescing exploits — the workload property §6.2 measures.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.workloads.datagen import GENRES, MARKETS, SEGMENTS

M14, M32, M20 = "qwen3-14b", "qwen3-32b", "gpt-oss-20b"

WorkloadBuilder = Callable[[], Tuple[dict, Callable[[int, int], List[Dict]]]]


def _bind_sampler(pool_fn: Callable[[random.Random], Dict]
                  ) -> Callable[[int, int], List[Dict]]:
    def sample(n: int, seed: int = 0) -> List[Dict]:
        rng = random.Random(seed)
        return [pool_fn(rng) for _ in range(n)]
    return sample


# ---------------------------------------------------------------------------
def w1_imdb_diamond() -> Tuple[dict, Callable]:
    """Diamond: plan → 3 searchers (join-heavy SQL ×2 each) → 3 analyzers
    (SQL ×1 each) → edit.  8 LLM / 9 CPU."""
    nodes = [
        {"id": "plan", "type": "llm", "model": M14, "max_new_tokens": 24,
         "est_prompt_tokens": 96,
         "prompt": "Plan an investigation of $genre movies after $year."},
    ]
    for i in range(3):
        nodes.append({
            "id": f"search{i}", "type": "llm", "model": [M14, M20, M32][i],
            "max_new_tokens": 48, "est_prompt_tokens": 256,
            "prompt": (
                f"Branch {i}: given ${{plan}}, summarize "
                "{{sql: SELECT title, rating FROM titles WHERE genre='$genre' "
                "AND year >= $year ORDER BY rating DESC LIMIT 10}} and cast "
                "{{sql: SELECT people.name FROM crew JOIN people ON "
                "crew.person_id = people.id WHERE crew.title_id = $tid "
                f"LIMIT 10}}}} for aspect {i}.")})
        nodes.append({
            "id": f"analyze{i}", "type": "llm", "model": [M32, M14, M20][i],
            "max_new_tokens": 64, "est_prompt_tokens": 320,
            "prompt": (
                f"Attribute findings of ${{search{i}}} using "
                "{{sql: SELECT count(*), avg(rating) FROM titles WHERE "
                f"genre='$genre'}}}} for aspect {i}.")})
    nodes.append({
        "id": "edit", "type": "llm", "model": M32, "max_new_tokens": 96,
        "est_prompt_tokens": 512,
        "prompt": "Synthesize ${analyze0} ${analyze1} ${analyze2}."})
    wf = {"name": "W1-IMDb-Diamond", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"genre": GENRES[rng.randrange(4)],
                "year": 1990 + 5 * rng.randrange(5),
                "tid": rng.randrange(64)}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def w2_imdb_triplechain() -> Tuple[dict, Callable]:
    """Three independent 3-LLM chains (movie / person / crew) merging into
    a final answer.  10 LLM / 3 CPU."""
    nodes = []
    chains = [
        ("movie", "{{sql: SELECT title, year FROM titles WHERE genre='$genre' "
                  "ORDER BY rating DESC LIMIT 5}}"),
        ("person", "{{sql: SELECT name, born FROM people WHERE born >= $born "
                   "LIMIT 5}}"),
        ("crew", "{{sql: SELECT role, count(*) FROM crew WHERE "
                 "title_id = $tid GROUP BY role}}"),
    ]
    for name, sql in chains:
        nodes.append({
            "id": f"{name}_fetch", "type": "llm", "model": M14,
            "max_new_tokens": 32, "est_prompt_tokens": 192,
            "prompt": f"Extract {name} facts from {sql}."})
        nodes.append({
            "id": f"{name}_reason", "type": "llm", "model": M14,
            "max_new_tokens": 48, "est_prompt_tokens": 224,
            "prompt": f"Reason over ${{{name}_fetch}} about $genre."})
        nodes.append({
            "id": f"{name}_draft", "type": "llm", "model": M20,
            "max_new_tokens": 48, "est_prompt_tokens": 256,
            "prompt": f"Draft a note from ${{{name}_reason}}."})
    nodes.append({
        "id": "merge", "type": "llm", "model": M32, "max_new_tokens": 96,
        "est_prompt_tokens": 512,
        "prompt": "Answer using ${movie_draft} ${person_draft} ${crew_draft}."})
    wf = {"name": "W2-IMDb-TripleChain", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"genre": GENRES[rng.randrange(6)],
                "born": 1940 + 10 * rng.randrange(4),
                "tid": rng.randrange(32)}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def w3_finewiki_longchain() -> Tuple[dict, Callable]:
    """Deep 9-LLM sequential chain; 6 steps block on DB retrievals —
    the critical-path stress test.  9 LLM / 6 CPU."""
    nodes = []
    prev = None
    for i in range(9):
        prompt = f"Step {i}: continue the investigation of topic $topic"
        if prev:
            prompt += f" given ${{{prev}}}"
        if i % 3 != 2:        # steps 0,1,3,4,6,7 → 6 retrievals
            prompt += (" with context {{sql: SELECT body FROM pages WHERE "
                       f"title = 'page_$p{i}'}}}}")
        nid = f"step{i}"
        nodes.append({"id": nid, "type": "llm",
                      "model": [M14, M20, M32][i % 3],
                      "max_new_tokens": 40, "est_prompt_tokens": 256,
                      "prompt": prompt + "."})
        prev = nid
    wf = {"name": "W3-FineWiki-LongChain", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        b = {"topic": GENRES[rng.randrange(len(GENRES))]}
        for i in range(9):
            b[f"p{i}"] = rng.randrange(256)
        return b
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def w4_finewiki_bridge() -> Tuple[dict, Callable]:
    """Main 9-LLM reasoning chain with 3 auxiliary DB lookups bridging in
    at irregular positions.  9 LLM / 3 CPU."""
    nodes = []
    prev = None
    aux_at = {2: 0, 5: 1, 7: 2}
    for i in range(9):
        prompt = f"Reason step {i} on $topic"
        if prev:
            prompt += f" from ${{{prev}}}"
        if i in aux_at:
            j = aux_at[i]
            prompt += (" plus aux {{sql: SELECT title, views FROM pages "
                       f"WHERE topic = '$aux{j}' ORDER BY views DESC "
                       "LIMIT 5}}")
        nid = f"hop{i}"
        nodes.append({"id": nid, "type": "llm",
                      "model": [M14, M14, M32][i % 3],
                      "max_new_tokens": 36, "est_prompt_tokens": 224,
                      "prompt": prompt + "."})
        prev = nid
    # irregular dependency insertion: hop3 also feeds hop8
    nodes[-1]["prompt"] += " Recall ${hop3}."
    wf = {"name": "W4-FineWiki-Bridge", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"topic": GENRES[rng.randrange(len(GENRES))],
                "aux0": GENRES[rng.randrange(4)],
                "aux1": GENRES[rng.randrange(4)],
                "aux2": GENRES[rng.randrange(4)]}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def w5_tpch_trident() -> Tuple[dict, Callable]:
    """Trident: plan → 3 concurrent analytical branches (3 TPC-H style
    aggregate SQLs each) → merge... 7 LLM / 9 CPU."""
    nodes = [
        {"id": "plan", "type": "llm", "model": M14, "max_new_tokens": 24,
         "est_prompt_tokens": 96,
         "prompt": "Plan revenue analysis for market $market."},
    ]
    branch_sql = [
        ("pricing",
         "{{sql: SELECT returnflag, sum(quantity), avg(price) FROM lineitem "
         "WHERE shipdate <= '$date' GROUP BY returnflag}}",
         "{{sql: SELECT count(*) FROM lineitem WHERE discount >= $disc}}",
         "{{sql: SELECT avg(totalprice) FROM orders WHERE "
         "orderdate >= '$date2'}}"),
        ("orders",
         "{{sql: SELECT count(*), avg(totalprice) FROM orders WHERE "
         "orderdate <= '$date'}}",
         "{{sql: SELECT segment, count(*) FROM customer WHERE "
         "market = '$market' GROUP BY segment}}",
         "{{sql: SELECT max(totalprice) FROM orders WHERE "
         "orderdate >= '$date2'}}"),
        ("volume",
         "{{sql: SELECT sum(quantity) FROM lineitem WHERE "
         "shipdate >= '$date2'}}",
         "{{sql: SELECT returnflag, count(*) FROM lineitem "
         "GROUP BY returnflag}}",
         "{{sql: SELECT count(*) FROM customer WHERE market = '$market'}}"),
    ]
    for name, s1, s2, s3 in branch_sql:
        nodes.append({
            "id": f"{name}_scan", "type": "llm",
            "model": {"pricing": M20, "orders": M14, "volume": M20}[name],
            "max_new_tokens": 48, "est_prompt_tokens": 384,
            "prompt": f"Given ${{plan}}, digest {s1} and {s2} and {s3}."})
        nodes.append({
            "id": f"{name}_judge", "type": "llm",
            "model": {"pricing": M32, "orders": M32, "volume": M14}[name],
            "max_new_tokens": 64, "est_prompt_tokens": 320,
            "prompt": f"Judge metric trends in ${{{name}_scan}}."})
    wf = {"name": "W5-TPCH-Trident", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"market": MARKETS[rng.randrange(3)],
                "date": f"199{rng.randrange(3,6)}-06-01",
                "date2": f"199{rng.randrange(0,3)}-01-01",
                "disc": round(0.02 * rng.randrange(1, 4), 2)}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def w6_tpch_fanout() -> Tuple[dict, Callable]:
    """Fan-out: broadcast (1 http) → 4 stage-1 agents (2 SQL each) →
    3 stage-2 aggregators (1 SQL each) → report.  9 LLM / 12 CPU."""
    nodes = [
        {"id": "broadcast", "type": "llm", "model": M14,
         "max_new_tokens": 24, "est_prompt_tokens": 128,
         "prompt": "Broadcast params for $market from "
                   "{{http: GET /params?market=$market&seg=$segment}}."},
    ]
    for i in range(4):
        nodes.append({
            "id": f"agent{i}", "type": "llm", "model": [M20, M14, M20, M14][i],
            "max_new_tokens": 48, "est_prompt_tokens": 384,
            "prompt": (
                f"Agent {i}: with ${{broadcast}}, analyze "
                "{{sql: SELECT segment, count(*) FROM customer WHERE "
                "market = '$market' GROUP BY segment}} and "
                "{{sql: SELECT returnflag, sum(price) FROM lineitem WHERE "
                "shipdate <= '$date' GROUP BY returnflag}}"
                f" for objective {i}.")})
    for j in range(3):
        src = " ".join(f"${{agent{i}}}" for i in range(4))
        nodes.append({
            "id": f"agg{j}", "type": "llm", "model": [M32, M20, M32][j],
            "max_new_tokens": 64, "est_prompt_tokens": 512,
            "prompt": (
                f"Aggregate metric {j} from {src} enriched by "
                f"{{{{http: GET /bench/metric{j}?market=$market}}}}.")})
    nodes.append({
        "id": "report", "type": "llm", "model": M32, "max_new_tokens": 96,
        "est_prompt_tokens": 512,
        "prompt": "Final report from ${agg0} ${agg1} ${agg2}."})
    wf = {"name": "W6-TPCH-Fanout", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"market": MARKETS[rng.randrange(3)],
                "segment": SEGMENTS[rng.randrange(3)],
                "date": f"199{rng.randrange(3,6)}-06-01"}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def wplus_linear() -> Tuple[dict, Callable]:
    """W+: lightweight LLM-only 3-node linear chain (online-serving probe)."""
    nodes = [
        {"id": "draft", "type": "llm", "model": M14, "max_new_tokens": 32,
         "est_prompt_tokens": 96, "prompt": "Draft an answer about $topic."},
        {"id": "refine", "type": "llm", "model": M14, "max_new_tokens": 32,
         "est_prompt_tokens": 160, "prompt": "Refine ${draft}."},
        {"id": "final", "type": "llm", "model": M14, "max_new_tokens": 48,
         "est_prompt_tokens": 192, "prompt": "Finalize ${refine}."},
    ]
    wf = {"name": "W+-Linear", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"topic": GENRES[rng.randrange(len(GENRES))]}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def wd_doc_draft() -> Tuple[dict, Callable]:
    """WD: retrieval-grounded briefing draft (3 LLM / 2 CPU).

    Built for MIXED batches: its context retrieval renders the same
    ``pages``-by-topic SQL template W4's aux lookups issue (topics drawn
    from the same 4-genre pool), so a multi-template batch of wd+w4
    coalesces requests ACROSS templates — the cross-template dedup the
    mega-DAG consolidation (``consolidate_multi``) exists to find.
    """
    nodes = [
        {"id": "outline", "type": "llm", "model": M14, "max_new_tokens": 24,
         "est_prompt_tokens": 128,
         "prompt": (
             "Outline a briefing on $topic using "
             "{{sql: SELECT title, views FROM pages WHERE topic = '$topic' "
             "ORDER BY views DESC LIMIT 5}} and "
             "{{sql: SELECT count(*) FROM pages WHERE topic = '$topic'}}.")},
        {"id": "draft", "type": "llm", "model": M14, "max_new_tokens": 48,
         "est_prompt_tokens": 224,
         "prompt": "Draft the briefing from ${outline}."},
        {"id": "polish", "type": "llm", "model": M32, "max_new_tokens": 48,
         "est_prompt_tokens": 256,
         "prompt": "Polish ${draft} for audience $aud."},
    ]
    wf = {"name": "WD-DocDraft", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"topic": GENRES[rng.randrange(4)],     # == W4's aux pool
                "aud": SEGMENTS[rng.randrange(3)]}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def wt_tool_pipeline() -> Tuple[dict, Callable]:
    """WT: llm → dependent tools → llm, all on one model.

    Unlike W1–W6 (whose tool args reference only bindings, so every tool
    is a DAG root), WT's tools consume the upstream LLM *output* — the
    shape where per-request CPU-GPU pipelining pays: query i's tools can
    run the moment ITS generation retires, overlapping the stragglers'
    decode, and its final-stage request joins the running batch.
    Bindings are per-query distinct so nothing coalesces away.
    """
    nodes = [
        {"id": "gen", "type": "llm", "model": M14, "max_new_tokens": 24,
         "est_prompt_tokens": 96,
         "prompt": "Angle $k: draft a claim about $topic."},
        {"id": "verify", "type": "tool", "op": "http",
         "args": "GET /api/verify?claim=${gen}&k=$k"},
        {"id": "count", "type": "tool", "op": "pyfn",
         "args": "wordcount(${gen})"},
        {"id": "final", "type": "llm", "model": M14, "max_new_tokens": 16,
         "est_prompt_tokens": 128,
         "prompt": "Finalize angle $k with ${verify} and ${count}."},
    ]
    wf = {"name": "WT-ToolPipeline", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        return {"topic": GENRES[rng.randrange(len(GENRES))],
                "k": rng.randrange(100000)}
    return wf, _bind_sampler(pool)


# ---------------------------------------------------------------------------
def ws_page_audit() -> Tuple[dict, Callable]:
    """WS: the data-scale per-row audit template (DESIGN.md §12.1).

    One query per ``pages`` row — the templated LLM-step-over-rows shape
    where an enumerator (``repro_torch.workloads.enumerators``) produces the
    bindings from the data itself instead of a random pool.  ``fetch`` is
    a per-row indexed point lookup (distinct per query); ``stats`` is a
    per-topic aggregate shared by every query of that topic, so a
    thousands-of-query batch coalesces it down to #topics physical
    executions.  The random sampler below keeps ``build_workload("ws",
    n)`` usable standalone (titles it draws exist in the finewiki DB).
    """
    nodes = [
        {"id": "fetch", "type": "tool", "op": "sql",
         "args": "SELECT views, topic FROM pages WHERE title = '$title'"},
        {"id": "stats", "type": "tool", "op": "sql",
         "args": ("SELECT count(*), avg(views) FROM pages "
                  "WHERE topic = '$topic'")},
        {"id": "assess", "type": "llm", "model": M14, "max_new_tokens": 24,
         "est_prompt_tokens": 160,
         "prompt": ("Assess page $title using ${fetch} against the "
                    "$topic norms ${stats}.")},
        {"id": "brief", "type": "llm", "model": M32, "max_new_tokens": 16,
         "est_prompt_tokens": 192,
         "prompt": "One-line brief of ${assess} for row $rank."},
    ]
    wf = {"name": "WS-PageAudit", "nodes": nodes}

    def pool(rng: random.Random) -> Dict:
        i = rng.randrange(20000)            # datagen's finewiki page count
        return {"title": f"page_{i}",
                "topic": GENRES[rng.randrange(len(GENRES))],
                "rank": i}
    return wf, _bind_sampler(pool)


WORKFLOWS: Dict[str, WorkloadBuilder] = {
    "w1": w1_imdb_diamond,
    "w2": w2_imdb_triplechain,
    "w3": w3_finewiki_longchain,
    "w4": w4_finewiki_bridge,
    "w5": w5_tpch_trident,
    "w6": w6_tpch_fanout,
    "w+": wplus_linear,
    "wt": wt_tool_pipeline,
    "wd": wd_doc_draft,
    "ws": ws_page_audit,
}

DATABASE_OF = {
    "w1": "imdb", "w2": "imdb", "w3": "finewiki", "w4": "finewiki",
    "w5": "tpch", "w6": "tpch", "w+": "finewiki", "wt": "finewiki",
    "wd": "finewiki", "ws": "finewiki",
}

# the default MIXED online-serving blend: a doc-draft template, the
# tool-dependent pipeline, and one analytics template, all over the same
# database so one ToolRuntime serves the whole mega-DAG
MIXED_PARTS = ("wd", "wt", "w4")


def _paper_scale_estimate(op: str, args: str) -> float:
    """Latency estimate matching the PAPER's backends (PostgreSQL with
    200M-row IMDb / SF=10 TPC-H; real external APIs) rather than the
    scaled-down minidb.  Used by the simulated backend; real mode profiles
    the actual minidb instead."""
    a = args.lower()
    if op == "http":
        return 2.00                       # external API + parse
    if op == "pyfn":
        return 0.02
    if "lineitem" in a or "orders" in a:
        return 0.50                       # SF=10 analytical aggregates
    if "join" in a:
        return 0.45                       # multi-way IMDb joins
    if "pages" in a:
        return 0.03                       # B-tree point lookups
    return 0.20


def build_graph(name: str, paper_scale_estimates: bool = True):
    """Parse workload ``name``'s template alone: (GraphSpec, database
    name).  The binding-enumerator path (``repro_torch.workloads.enumerators``)
    uses this to pair the template with data-derived bindings instead of
    the random sampler."""
    from repro_torch.core.graphspec import GraphSpec
    from repro_torch.core.parser import parse_workflow
    wf, _ = WORKFLOWS[name]()
    graph = parse_workflow(wf)
    if paper_scale_estimates:
        nodes = []
        for nid, spec in graph.nodes.items():
            if not spec.is_llm() and not spec.est_seconds:
                spec = spec.with_(
                    est_seconds=_paper_scale_estimate(spec.op, spec.args))
            nodes.append(spec)
        graph = GraphSpec(graph.name, nodes, graph.edges)
    return graph, DATABASE_OF[name]


def build_workload(name: str, n_queries: int, seed: int = 0,
                   paper_scale_estimates: bool = True):
    """Returns (GraphSpec, bindings, database name)."""
    graph, dbname = build_graph(
        name, paper_scale_estimates=paper_scale_estimates)
    _, sampler = WORKFLOWS[name]()
    bindings = sampler(n_queries, seed)
    return graph, bindings, dbname


def build_mixed_workload(n_queries: int, seed: int = 0,
                         parts: Sequence[str] = MIXED_PARTS,
                         paper_scale_estimates: bool = True):
    """A mixed multi-template batch: ``n_queries`` split (round-robin
    remainders first) across ``parts``.

    Returns ``(batches, database)`` where ``batches`` is the
    ``[(GraphSpec, bindings), ...]`` list ``consolidate_multi`` takes.
    Every part must live on the same database (one ToolRuntime serves
    the merged graph).
    """
    parts = list(parts)
    if not parts:
        raise ValueError("mixed workload needs at least one part")
    dbs = {DATABASE_OF[p] for p in parts}
    if len(dbs) > 1:
        raise ValueError(f"mixed parts span databases {sorted(dbs)}; "
                         "pick templates sharing one backend")
    base, rem = divmod(n_queries, len(parts))
    batches = []
    for i, part in enumerate(parts):
        n_i = base + (1 if i < rem else 0)
        g, bindings, _ = build_workload(
            part, n_i, seed=seed + i,
            paper_scale_estimates=paper_scale_estimates)
        batches.append((g, bindings))
    return batches, dbs.pop()
