"""Architectures, one module each, found by the name a configuration's
``model`` section gives under ``arch`` (``gqa`` where it gives none):
``archs/<arch>.py`` under the benchmark root's ``portbench/`` first, then
beside this package (``harness/spec.py``).  A model whose layers the
harness does not know yet comes with a module of its own and needs no
edit of the harness, the reference or the yardstick.

Every function takes the configuration file's ``model`` section ``m``
(with its ``arch`` key, if any).  A module gives:

- ``layout(m)``: ``{key: (shape, dtype name, std)}``, every tensor of the
  checkpoint the port loads (``reference/weights.py`` draws each from
  the seed and its key; the harness fills the port's parameters from it
  and sizes the weights by it);
- ``served_logits(m, seed, seqs, *, device, prefill_quantum, precision)``:
  the plain float32 reference, teacher-forced over each ``(prompt,
  served)`` pair, one ``(len(served), vocab_size)`` tensor each, and with
  ``precision="fp8"`` the control; it imports no kernel of the port and
  no JAX, makes its weights with ``reference.weights`` from ``layout``,
  and computes with TF32 off;
- ``kv_bytes_per_token(m)``: the bytes the port's page pool holds for
  one token over all layers (``harness/cell.pool_pages``);
- ``token_flops(m, contexts)``: the model FLOPs of tokens that attend
  over ``contexts`` keys each (``metrics/mfu.py``);
- optionally ``port_config(m)``: the port's ``ModelConfig``, where it
  needs more than the section's fields passed through.
"""

DEFAULT = "gqa"


def arch_name(model: dict) -> str:
    """The architecture a configuration's ``model`` section names."""
    return model.get("arch", DEFAULT)


def default(model: dict):
    """``archs/gqa.py``, behind the names the reference and the yardstick
    keep from before architectures were found by name (``weights.layout``,
    ``make``, ``fill_params``, ``model.served_logits``,
    ``costs.matmul_params``, ``token_flops``).  They serve a ``gqa``
    configuration only: for another this raises, and the harness takes
    that architecture's module from ``Bench.arch``."""
    name = arch_name(model)
    if name != DEFAULT:
        raise ValueError(f"the configuration names arch {name!r}: use "
                         f"archs/{name}.py, found by Bench.arch")
    from portbench.archs import gqa
    return gqa
