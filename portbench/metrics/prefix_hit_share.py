"""Share of the window's prompt tokens served from shared pages:
``prefill_tokens_saved / (prefill_tokens + prefill_tokens_saved)``, the
engine's own counters (``EngineStats``), in %."""


def read(run):
    saved = run.stats["prefill_tokens_saved"]
    total = run.stats["prefill_tokens"] + saved
    return 100.0 * saved / total if total else None
