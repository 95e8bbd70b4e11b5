"""Durable job store: the batch survives kill -9 (DESIGN.md §12.2).

Two persistence layers, both keyed so a restart re-pays NOTHING that
already finished:

* ``JobStore`` — an append-only JSONL *signature journal*.  Every
  completed (query, node) result is journaled under its
  consolidation-layer signature (``signature_map``), the same identity
  request dedup merges on — so one journal line covers every logical
  query that shares the physical execution, cross-template dedup
  included, and a RE-consolidated batch after restart maps its
  (query, node) pairs back onto the journaled lines by recomputing the
  same signatures.  Each line carries its own checksum: a torn tail
  from kill -9 mid-write is detected and dropped, never half-applied.
  Writes happen incrementally from a ``BatchState`` listener (flushed
  per line, fsynced every ``fsync_every`` records and on close), so
  the journal is as fresh as the last completed result.

* ``save_batch_state`` / ``load_batch_state`` — one-shot atomic JSON
  snapshots of the whole (query, node) → result map (the original
  ``runtime.checkpoint`` API, absorbed here).  ``load_batch_state``
  VALIDATES every entry against the live graph — unknown node ids, out
  of range queries, or malformed entries raise ``CheckpointError``
  with a diagnostic (path, expected vs found) instead of silently
  poisoning ``BatchState``'s completion accounting.

Resume contract: the journal stores *values by signature*; replaying a
signature into a (query, node) pair is only sound when the pair's
output is a deterministic function of the signature.  That holds for
tool nodes and temperature-0 LLM nodes by construction (the influence
tuple IS the signature); sampled (temperature > 0) LLM nodes get a
per-query suffix so they never replay across queries.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Optional, Set, Tuple

from repro_torch.debugsync import named_lock
from repro_torch.runtime.coordinator import BatchState

_MAGIC = "halo-jobstore"
_VERSION = 1


class CheckpointError(ValueError):
    """A checkpoint/journal failed validation against the live run."""


# ---------------------------------------------------------------------------
# signature keys
# ---------------------------------------------------------------------------

def _key(sig: str) -> str:
    # journal lines store a fixed-width digest, not the raw signature
    # (LLM signatures embed whole influence tuples and can be huge)
    return hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()


def signature_map(cons) -> Dict[Tuple[int, str], str]:
    """(query, node) → durable journal key, from the consolidation
    layer's signature table (DESIGN.md §8.1).

    Signatures live in the base-id space (multi-template consolidation
    suffixes a lineage digest), so re-consolidating the same
    (template, bindings) submissions after a restart reproduces the
    same keys — which is what lets the journal be replayed into a
    fresh ``BatchState``.  Sampled LLM nodes (temperature > 0) get a
    per-query suffix: their outputs are not functions of the signature
    alone, so they must never replay across queries.
    """
    out: Dict[Tuple[int, str], str] = {}
    for nid, m in cons.macros.items():
        per_query = m.spec.is_llm() and m.spec.temperature > 0
        for local, q in enumerate(m.queries):
            key = _key(m.unique_signatures[m.signature_of_query[local]])
            out[(q, nid)] = f"{key}#q{q}" if per_query else key
    return out


# ---------------------------------------------------------------------------
# the signature journal
# ---------------------------------------------------------------------------

def _line_checksum(key: str, node: str, value: str) -> str:
    payload = f"{key}|{node}|{value}".encode()
    return hashlib.blake2b(payload, digest_size=8).hexdigest()


class JobStore:
    """Append-only signature journal with kill -9-tolerant loading."""

    def __init__(self, path: str, fsync_every: int = 32):
        self.path = path
        self.fsync_every = max(int(fsync_every), 1)
        self._lock = named_lock("JobStore._lock")
        self._seen: Dict[str, str] = {}       # guarded-by: self._lock
        self._replaying: Set[str] = set()     # guarded-by: self._lock
        self._writes_since_sync = 0           # guarded-by: self._lock
        self._f = None                        # guarded-by: self._lock
        self.dropped_lines = 0                # torn/corrupt tail lines
        self.restored_results = 0             # guarded-by: self._lock
        self.re_executed: Set[str] = set()    # guarded-by: self._lock
        self._truncate_to: Optional[int] = None   # torn-tail repair offset
        self._needs_newline = False           # valid tail missing its "\n"
        with self._lock:
            self._load()
            self._at_open = frozenset(self._seen)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if self._truncate_to is not None:
            # repair before reopening for append: without this, the next
            # record() would concatenate onto the torn fragment, merging
            # into one invalid line and poisoning every later load
            with open(path, "r+b") as tf:
                tf.truncate(self._truncate_to)
                tf.flush()
                os.fsync(tf.fileno())
        self._f = open(path, "a", encoding="utf-8")
        if self._needs_newline:
            self._f.write("\n")
            self._f.flush()
        if not self._at_open and self._f.tell() == 0:
            header = {"magic": _MAGIC, "version": _VERSION}
            self._f.write(json.dumps(header) + "\n")
            self._f.flush()

    # ------------------------------------------------------------- load
    # requires: self._lock
    def _load(self) -> None:
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        raw_lines = data.splitlines(keepends=True)
        offset = 0          # bytes consumed; trails the current line
        valid_end = 0       # end of the last intact line
        for i, raw in enumerate(raw_lines):
            offset += len(raw)
            last = i == len(raw_lines) - 1
            try:
                line = raw.decode("utf-8").strip()
                entry = json.loads(line) if line else None
            except (UnicodeDecodeError, json.JSONDecodeError):
                # torn write (kill -9 mid-append): only tolerable at the
                # tail — anywhere else the file is corrupt, not torn
                if last:
                    self.dropped_lines += 1
                    continue
                raise CheckpointError(
                    f"corrupt jobstore {self.path}: line {i + 1} is not "
                    "valid JSON (and is not the torn tail)") from None
            if entry is None:                   # blank line
                valid_end = offset
                continue
            if "magic" in entry:
                if (entry.get("magic") != _MAGIC
                        or entry.get("version") != _VERSION):
                    raise CheckpointError(
                        f"jobstore {self.path}: header {entry!r} does not "
                        f"match {_MAGIC} v{_VERSION}")
                valid_end = offset
                continue
            key, node = entry.get("k"), entry.get("n", "")
            value, check = entry.get("v"), entry.get("c")
            if key is None or value is None \
                    or check != _line_checksum(key, node, value):
                if last:
                    self.dropped_lines += 1
                    continue
                raise CheckpointError(
                    f"jobstore {self.path}: line {i + 1} failed its "
                    "checksum (and is not the torn tail)")
            self._seen[key] = value
            valid_end = offset
        if valid_end < len(data):
            self._truncate_to = valid_end
        elif data and not data.endswith(b"\n"):
            # whole file intact but the final newline never landed:
            # terminate it so the first appended record starts clean
            self._needs_newline = True

    # ---------------------------------------------------------- journal
    def record(self, key: str, node: str, value: str) -> None:
        """Journal one completed result under its signature key.

        Repeat keys within a run are the normal fan-out of one physical
        execution across the logical queries that share it — journaled
        once.  A key that was already in the journal at open means the
        work was RE-executed after a resume (the restore should have
        replayed it); counted in ``re_executed``, which resume tests
        pin to zero.
        """
        with self._lock:
            if self._f is None:
                # closed (or still opening): a straggler worker thread
                # that outlives the shutdown join can fire the listener
                # after close() — drop the write instead of crashing
                return
            if key in self._replaying:
                return                  # our own restore replay, not work
            if key in self._at_open:
                self.re_executed.add(key)
                return
            if key in self._seen:
                return                  # same-run fan-out of one execution
            self._seen[key] = value
            self._append_locked(key, node, value)

    # requires: self._lock
    def _append_locked(self, key: str, node: str, value: str) -> None:
        entry = {"k": key, "n": node, "v": value,
                 "c": _line_checksum(key, node, value)}
        self._f.write(json.dumps(entry) + "\n")
        self._f.flush()
        self._writes_since_sync += 1
        if self._writes_since_sync >= self.fsync_every:
            os.fsync(self._f.fileno())
            self._writes_since_sync = 0

    def lookup(self, key: str) -> Optional[str]:
        with self._lock:
            return self._seen.get(key)

    # ----------------------------------------------------------- resume
    def restore_into(self, state: BatchState,
                     sig_of: Dict[Tuple[int, str], str]) -> int:
        """Replay every journaled signature into ``state``: each
        (query, node) whose key is journaled gets its stored value, so
        neither workers nor the dispatcher re-execute it.  Returns the
        number of results restored."""
        with self._lock:
            seen = dict(self._seen)
        hits = [(q, nid, key) for (q, nid), key in sig_of.items()
                if key in seen]
        keys = {key for _, _, key in hits}
        with self._lock:
            self._replaying |= keys
        n = 0
        try:
            for q, nid, key in hits:
                with state.lock:
                    present = (q, nid) in state.results
                if not present:
                    state.set_result(q, nid, seen[key])
                    n += 1
        finally:
            with self._lock:
                self._replaying -= keys
                self.restored_results += n
        return n

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, int]:
        with self._lock:
            return {
                "completed_signatures": len(self._seen),
                "restored_signatures": len(self._at_open),
                "restored_results": self.restored_results,
                "re_executed_signatures": len(self.re_executed),
                "dropped_lines": self.dropped_lines,
            }

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# one-shot snapshots (the absorbed runtime.checkpoint API)
# ---------------------------------------------------------------------------

def save_batch_state(state: BatchState, path: str) -> None:
    """Atomic JSON snapshot of the (query, node) → result map."""
    with state.lock:
        payload = {
            "n_queries": state.n,
            "results": [[q, node, val]
                        for (q, node), val in state.results.items()],
        }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())       # data durable before the rename
        os.replace(tmp, path)                      # atomic commit
        try:
            dfd = os.open(d, os.O_RDONLY)          # make the rename durable
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass            # directory fsync unsupported on this platform
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_batch_state(state: BatchState, path: str) -> int:
    """Populate ``state`` from a snapshot. Returns #results restored.

    Every entry is validated against the LIVE graph before anything is
    applied: a stale or corrupt checkpoint raises ``CheckpointError``
    naming the path and the expected-vs-found mismatch, instead of
    silently ``set_result``-ing entries that would inflate completion
    counts for the wrong nodes.
    """
    try:
        with open(path) as f:
            payload = json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"corrupt checkpoint {path}: not valid JSON ({e})") from None
    if not isinstance(payload, dict) or \
            not isinstance(payload.get("results"), list) or \
            "n_queries" not in payload:
        found = (sorted(payload) if isinstance(payload, dict)
                 else type(payload).__name__)
        raise CheckpointError(
            f"corrupt checkpoint {path}: expected "
            "{'n_queries': ..., 'results': [[q, node, value], ...]}, "
            f"found keys {found}")
    with state.lock:
        n_queries = state.n
        known = set(state.graph.nodes)
    if payload["n_queries"] != n_queries:
        raise CheckpointError(
            f"checkpoint {path} was taken with a different batch size: "
            f"expected {n_queries} queries, found {payload['n_queries']}")
    entries = []
    for i, entry in enumerate(payload["results"]):
        try:
            q, node, val = entry
            q = int(q)
        except (TypeError, ValueError):
            raise CheckpointError(
                f"corrupt checkpoint {path}: entry {i} is {entry!r}, "
                "expected [query, node, value]") from None
        if node not in known:
            sample = ", ".join(sorted(known)[:4])
            raise CheckpointError(
                f"checkpoint {path}: entry {i} references node {node!r} "
                f"which is not in the live graph (expected one of "
                f"{len(known)} nodes: {sample}, ...) — stale checkpoint "
                "from a different graph?")
        if not state.serves(q, node):
            raise CheckpointError(
                f"checkpoint {path}: entry {i} assigns query {q} to node "
                f"{node!r}, but the live graph's template slice for that "
                f"node is {state.queries_for(node)[:8]}... — stale "
                "checkpoint from a different batch?")
        entries.append((q, node, val))
    # validate-then-apply: nothing is written unless EVERY entry passed
    n = 0
    for q, node, val in entries:
        state.set_result(q, node, val)
        n += 1
    return n
