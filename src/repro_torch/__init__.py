"""PyTorch/CUDA port of the Halo reproduction's serving engine.

``repro_torch`` mirrors the layout of the JAX package ``repro`` (configs,
engine, engine/models, kernels/<name>) so each module's counterpart is
easy to find, but it imports neither ``jax`` nor anything of ``repro``:
the modules it needs that were JAX-free there (debugsync, prefix_tree,
tokenizer, the config dataclasses) are kept here as copies.

The prefill and paged-decode attention run in hand-written CUDA kernels
for Hopper (``kernels/csrc/*.cu``), built with ``nvcc`` at first use and
bound with ``ctypes``; every other op is plain PyTorch.  Importing this
package starts no build and touches no device.
"""
