"""MiniDB — in-memory relational engine (the offline PostgreSQL stand-in).

Preserves the execution characteristics Halo schedules around:
* queries are genuinely CPU-bound Python row scans (I/O-ish latency);
* hash indexes give point lookups a real fast path (index vs seq scan);
* EXPLAIN returns a cost estimate (rows × per-row cost, index-aware) —
  the hook the OperatorProfiler uses for SQL T_prep estimates;
* prepared statements: parse once, bind many (reused within an epoch).

SQL subset (everything the W1–W6 workloads need):
  SELECT col | agg(col) [, ...] FROM t [JOIN t2 ON a = b]
  [WHERE col OP val [AND ...]] [GROUP BY col]
  [ORDER BY col [DESC]] [LIMIT n]
with OP ∈ {=, !=, <, <=, >, >=}; aggregates SUM/AVG/COUNT/MIN/MAX.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# per-row scan cost used by EXPLAIN (calibrated to this container's python)
SEQ_ROW_COST = 2.0e-7
INDEX_PROBE_COST = 2.0e-6
OUTPUT_ROW_COST = 5.0e-7


@dataclass
class Table:
    name: str
    columns: List[str]
    rows: List[tuple] = field(default_factory=list)
    indexes: Dict[str, Dict[Any, List[int]]] = field(default_factory=dict)

    def col_ix(self, col: str) -> int:
        return self.columns.index(col)

    def build_index(self, col: str) -> None:
        ix = self.col_ix(col)
        index: Dict[Any, List[int]] = {}
        for i, r in enumerate(self.rows):
            index.setdefault(r[ix], []).append(i)
        self.indexes[col] = index


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

_AGG = re.compile(r"^(sum|avg|count|min|max)\((\*|[\w.]+)\)$", re.I)
_Q = re.compile(
    r"^\s*select\s+(?P<select>.+?)\s+from\s+(?P<table>\w+)"
    r"(?:\s+join\s+(?P<join>\w+)\s+on\s+(?P<jl>[\w.]+)\s*=\s*(?P<jr>[\w.]+))?"
    r"(?:\s+where\s+(?P<where>.+?))?"
    r"(?:\s+group\s+by\s+(?P<group>[\w.]+))?"
    r"(?:\s+order\s+by\s+(?P<order>[\w.]+)(?P<desc>\s+desc)?)?"
    r"(?:\s+limit\s+(?P<limit>\d+))?\s*;?\s*$",
    re.I | re.S)
_COND = re.compile(r"([\w.]+)\s*(<=|>=|!=|=|<|>)\s*('(?:[^']*)'|[-\w.]+)")

_OPS: Dict[str, Callable[[Any, Any], bool]] = {
    "=": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def _parse_val(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("'"):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


@dataclass(frozen=True)
class Query:
    select: Tuple[Tuple[str, str], ...]   # (agg|'', column)
    table: str
    join: Optional[Tuple[str, str, str]]  # (table2, left_col, right_col)
    where: Tuple[Tuple[str, str, Any], ...]
    group_by: Optional[str]
    order_by: Optional[str]
    desc: bool
    limit: Optional[int]


def parse_sql(sql: str) -> Query:
    m = _Q.match(sql)
    if not m:
        raise ValueError(f"unsupported SQL: {sql!r}")
    select: List[Tuple[str, str]] = []
    for part in m.group("select").split(","):
        part = part.strip()
        am = _AGG.match(part)
        if am:
            select.append((am.group(1).lower(), am.group(2)))
        else:
            select.append(("", part))
    join = None
    if m.group("join"):
        join = (m.group("join"), m.group("jl"), m.group("jr"))
    where: List[Tuple[str, str, Any]] = []
    if m.group("where"):
        for c in re.split(r"\s+and\s+", m.group("where"), flags=re.I):
            cm = _COND.match(c.strip())
            if not cm:
                raise ValueError(f"unsupported condition: {c!r}")
            where.append((cm.group(1), cm.group(2), _parse_val(cm.group(3))))
    return Query(
        select=tuple(select), table=m.group("table"), join=join,
        where=tuple(where), group_by=m.group("group"),
        order_by=m.group("order"), desc=bool(m.group("desc")),
        limit=int(m.group("limit")) if m.group("limit") else None)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class MiniDB:
    def __init__(self):
        self.tables: Dict[str, Table] = {}
        self._prepared: Dict[str, Query] = {}
        # stats
        self.queries_executed = 0
        self.rows_scanned = 0
        self.prepared_hits = 0

    # ---------------------------------------------------------------- schema
    def create_table(self, name: str, columns: Sequence[str],
                     rows: Sequence[tuple]) -> None:
        self.tables[name] = Table(name, list(columns), [tuple(r) for r in rows])

    def create_index(self, table: str, col: str) -> None:
        self.tables[table].build_index(col)

    # ----------------------------------------------------------------- helpers
    def _resolve(self, col: str, t1: Table, t2: Optional[Table]
                 ) -> Tuple[int, int]:
        """column → (source: 0|1, index). Supports table-qualified names."""
        if "." in col:
            tname, c = col.split(".", 1)
            if tname == t1.name:
                return 0, t1.col_ix(c)
            if t2 is not None and tname == t2.name:
                return 1, t2.col_ix(c)
            raise KeyError(f"unknown table in {col!r}")
        if col in t1.columns:
            return 0, t1.col_ix(col)
        if t2 is not None and col in t2.columns:
            return 1, t2.col_ix(col)
        raise KeyError(f"unknown column {col!r}")

    # ----------------------------------------------------------------- execute
    def prepare(self, sql: str) -> Query:
        q = self._prepared.get(sql)
        if q is None:
            q = parse_sql(sql)
            self._prepared[sql] = q
        else:
            self.prepared_hits += 1
        return q

    def execute(self, sql: str) -> List[tuple]:
        return self.execute_query(self.prepare(sql))

    def execute_query(self, q: Query) -> List[tuple]:
        self.queries_executed += 1
        t1 = self.tables[q.table]
        t2 = self.tables[q.join[0]] if q.join else None

        # --- base scan with pushed-down single-table predicates ----------
        eq_pred = next(((c, v) for c, op, v in q.where
                        if op == "=" and self._pred_on_base(c, t1, t2)
                        and self._col_name(c) in t1.indexes), None)
        if eq_pred is not None:
            col, val = eq_pred
            idx = t1.indexes[self._col_name(col)]
            base_ids = idx.get(val, [])
            base_rows = [t1.rows[i] for i in base_ids]
            self.rows_scanned += len(base_rows) + 1
        else:
            base_rows = t1.rows
            self.rows_scanned += len(t1.rows)

        # --- join ----------------------------------------------------------
        if t2 is not None:
            jt, jl, jr = q.join
            sl, li = self._resolve(jl, t1, t2)
            sr, ri = self._resolve(jr, t1, t2)
            if sl != 0:                     # normalize: left col on t1
                li, ri = ri, li
            right_col = t2.columns[ri]
            if right_col not in t2.indexes:
                t2.build_index(right_col)
            ridx = t2.indexes[right_col]
            joined: List[tuple] = []
            for r in base_rows:
                for j in ridx.get(r[li], ()):
                    joined.append(r + t2.rows[j])
                    self.rows_scanned += 1
            rows = joined
            columns_all = t1.columns + t2.columns
            # resolver over the concatenated row
            def col_ix(col: str) -> int:
                s, i = self._resolve(col, t1, t2)
                return i if s == 0 else len(t1.columns) + i
        else:
            rows = list(base_rows)
            def col_ix(col: str) -> int:
                return self._resolve(col, t1, None)[1]

        # --- residual filters ----------------------------------------------
        for col, op, val in q.where:
            if eq_pred is not None and (col, val) == eq_pred and op == "=":
                continue
            ix = col_ix(col)
            f = _OPS[op]
            rows = [r for r in rows if r[ix] is not None and f(r[ix], val)]

        # --- group by / aggregates -----------------------------------------
        if q.group_by or any(a for a, _ in q.select):
            rows = self._aggregate(q, rows, col_ix)
        else:
            ixs = [col_ix(c) for _, c in q.select]
            rows = [tuple(r[i] for i in ixs) for r in rows]

        # --- order / limit ---------------------------------------------------
        if q.order_by:
            out_cols = [c for _, c in q.select]
            if q.order_by in out_cols:
                key_ix = out_cols.index(q.order_by)
                rows.sort(key=lambda r: r[key_ix], reverse=q.desc)
            # ordering by a non-projected column after aggregation: skip
        if q.limit is not None:
            rows = rows[:q.limit]
        return rows

    def _pred_on_base(self, col: str, t1: Table, t2: Optional[Table]) -> bool:
        try:
            return self._resolve(col, t1, t2)[0] == 0
        except KeyError:
            return False

    @staticmethod
    def _col_name(col: str) -> str:
        return col.split(".", 1)[1] if "." in col else col

    def _aggregate(self, q: Query, rows: List[tuple],
                   col_ix: Callable[[str], int]) -> List[tuple]:
        groups: Dict[Any, List[tuple]] = {}
        if q.group_by:
            gix = col_ix(q.group_by)
            for r in rows:
                groups.setdefault(r[gix], []).append(r)
        else:
            groups[None] = rows

        def agg_val(agg: str, col: str, rs: List[tuple]) -> Any:
            if agg == "count":
                return len(rs)
            vals = [r[col_ix(col)] for r in rs]
            vals = [v for v in vals if v is not None]
            if not vals:
                return None
            if agg == "sum":
                return sum(vals)
            if agg == "avg":
                return sum(vals) / len(vals)
            if agg == "min":
                return min(vals)
            if agg == "max":
                return max(vals)
            raise ValueError(agg)

        out: List[tuple] = []
        for key in sorted(groups, key=lambda k: (k is None, k)):
            rs = groups[key]
            row: List[Any] = []
            for agg, col in q.select:
                if agg:
                    row.append(agg_val(agg, col, rs))
                elif q.group_by and col == q.group_by:
                    row.append(key)
                else:
                    row.append(rs[0][col_ix(col)])
            out.append(tuple(row))
        return out

    # ----------------------------------------------------------------- explain
    def explain(self, sql: str) -> float:
        """Cost estimate in seconds (the EXPLAIN hook for the profiler)."""
        try:
            q = self.prepare(sql)
        except (ValueError, KeyError):
            return 0.05
        t1 = self.tables.get(q.table)
        if t1 is None:
            return 0.05
        n = len(t1.rows)
        uses_index = any(
            op == "=" and self._col_name(c) in t1.indexes
            for c, op, v in q.where)
        if uses_index:
            # selectivity estimate: uniform distribution over index keys
            col = next(self._col_name(c) for c, op, v in q.where
                       if op == "=" and self._col_name(c) in t1.indexes)
            nkeys = max(len(t1.indexes[col]), 1)
            est_rows = max(n // nkeys, 1)
            cost = INDEX_PROBE_COST + est_rows * OUTPUT_ROW_COST
        else:
            est_rows = n
            cost = n * SEQ_ROW_COST
        if q.join:
            t2 = self.tables.get(q.join[0])
            fan = 2.0 if t2 is None else max(len(t2.rows) / max(n, 1), 1.0)
            cost += est_rows * min(fan, 4.0) * OUTPUT_ROW_COST
        if q.group_by:
            cost += est_rows * OUTPUT_ROW_COST
        return cost
