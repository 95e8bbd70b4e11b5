"""Back-compat shim — checkpointing moved into the durable job layer.

The one-shot snapshot API (``save_batch_state`` / ``load_batch_state``)
and the signature journal now live in ``repro_torch.runtime.jobstore``
(DESIGN.md §12.2); import from there.

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from repro_torch.runtime.jobstore import (CheckpointError, load_batch_state,
                                          save_batch_state)

__all__ = ["CheckpointError", "load_batch_state", "save_batch_state"]
