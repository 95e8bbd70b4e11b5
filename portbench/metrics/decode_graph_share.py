"""Decode steps that ran as a replayed CUDA graph, as a share of the
window's decode steps: the model's ``decode_graph_replays`` over
``span_n.engine.decode``.  A step that runs eagerly or captures its
graph counts in the steps only.  None on a program that replays no
graph (no such counter)."""
from portbench.harness.spans import count


def read(run):
    n = count(run.stats, "engine.decode")
    replays = run.stats.get("decode_graph_replays")
    if n is None or replays is None:
        return None
    return replays / n
