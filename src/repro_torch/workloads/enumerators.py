"""Binding enumerators — thousands-of-query batches from DATA
(DESIGN.md §12.1).

The W1–W6/wt/wd samplers draw bindings from small random pools; the
paper's headline workloads bind one query per *row of data* (audit
every page, score every order).  The enumerators here produce those
binding lists from the three data shapes the repo already has:

* ``enumerate_table``  — rows of a ``minidb`` table;
* ``enumerate_sql``    — the result set of any supported SQL query
  (projections, joins, aggregates), so the batch can be "one query per
  group" as easily as "one per row";
* ``enumerate_csv``    — rows of a CSV file on disk.

Each returns the plain ``List[Dict[str, str]]`` the consolidation layer
already takes, so the output feeds ``build_workload`` /
``consolidate_multi`` (and ``ProcessorSession.submit``) unchanged —
enumerated batches dedup, graft, plan and checkpoint exactly like
sampled ones.  ``build_enumerated_workload`` pairs a registered
template with its canonical enumeration (the enumerator → orchestrator
→ worker-pool shape).

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import csv
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.workloads.minidb import MiniDB, parse_sql

Binding = Dict[str, str]


def _coerce(rows: Sequence[Sequence], names: Sequence[str],
            params: Optional[Dict[str, str]],
            limit: Optional[int]) -> List[Binding]:
    """Rows × column names → binding dicts (values stringified, the
    form ``render()`` interpolates).  ``params`` maps binding key →
    source column; default binds every column under its own name."""
    if params is None:
        params = {c: c for c in names}
    ix: Dict[str, int] = {}
    for key, col in params.items():
        try:
            ix[key] = names.index(col)
        except ValueError:
            raise KeyError(
                f"enumerator param {key!r} wants column {col!r}; "
                f"available columns: {list(names)}") from None
    if limit is not None:
        rows = rows[:limit]
    return [{key: str(r[i]) for key, i in ix.items()} for r in rows]


def enumerate_table(db: MiniDB, table: str,
                    params: Optional[Dict[str, str]] = None,
                    where: Optional[str] = None,
                    limit: Optional[int] = None) -> List[Binding]:
    """One binding per row of ``table`` (insertion order, so the batch
    is deterministic).  ``where`` is an optional SQL predicate pushed
    through the normal query path."""
    t = db.tables[table]
    if where:
        sql = f"SELECT {', '.join(t.columns)} FROM {table} WHERE {where}"
        rows = db.execute(sql)
    else:
        rows = t.rows
    return _coerce(rows, t.columns, params, limit)


def _output_columns(sql: str) -> List[str]:
    """Names of a query's projected columns: bare columns keep their
    name (unqualified), aggregates are ``agg(col)``."""
    names = []
    for agg, col in parse_sql(sql).select:
        col = col.split(".", 1)[1] if "." in col else col
        names.append(f"{agg}({col})" if agg else col)
    return names


def enumerate_sql(db: MiniDB, sql: str,
                  params: Optional[Dict[str, str]] = None,
                  limit: Optional[int] = None) -> List[Binding]:
    """One binding per result row of ``sql`` (any query minidb
    supports).  ``params`` maps binding key → projected column name —
    bare columns by name, aggregates as ``"agg(col)"``."""
    rows = db.execute(sql)
    return _coerce(rows, _output_columns(sql), params, limit)


def enumerate_csv(path: str,
                  params: Optional[Dict[str, str]] = None,
                  limit: Optional[int] = None) -> List[Binding]:
    """One binding per CSV row (header row names the columns)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"CSV {path!r} is empty (no header row)") \
                from None
        rows = list(reader)
    return _coerce(rows, [h.strip() for h in header], params, limit)


# ---------------------------------------------------------------------------
# canonical per-template enumerations
# ---------------------------------------------------------------------------

def _ws_enumeration(db: MiniDB, limit: int) -> List[Binding]:
    # one query per pages row; rank/title distinct per row, topic drawn
    # from the row itself so the per-topic `stats` aggregate coalesces
    return enumerate_sql(
        db, f"SELECT id, title, topic FROM pages ORDER BY id LIMIT {limit}",
        params={"rank": "id", "title": "title", "topic": "topic"})


# workload name -> fn(db, limit) producing its data-derived bindings
ENUMERATIONS: Dict[str, Callable[[MiniDB, int], List[Binding]]] = {
    "ws": _ws_enumeration,
}


def build_enumerated_workload(name: str, limit: int = 2048,
                              db: Optional[MiniDB] = None,
                              paper_scale_estimates: bool = True):
    """A data-scale batch: (GraphSpec, bindings, database name, MiniDB).

    Like ``build_workload`` but the bindings are ENUMERATED from the
    workload's own database rather than sampled — one query per row the
    registered enumeration yields, capped at ``limit``.  The populated
    ``MiniDB`` is returned too so the caller's ``ToolRuntime`` queries
    the same instance the bindings came from.
    """
    from repro_torch.workloads.datagen import build_database
    from repro_torch.workloads.library import build_graph
    if name not in ENUMERATIONS:
        raise KeyError(f"no enumeration registered for workload {name!r} "
                       f"(have: {sorted(ENUMERATIONS)})")
    graph, dbname = build_graph(
        name, paper_scale_estimates=paper_scale_estimates)
    if db is None:
        db = build_database(dbname)
    bindings = ENUMERATIONS[name](db, limit)
    return graph, bindings, dbname, db
