"""Attention kernels of the port: hand-written CUDA for Hopper.

Layout per kernel: ``kernels/<name>/ops.py`` (the wrapper: checks its
inputs, launches the CUDA kernel for CUDA tensors and counts launches,
takes the plain version for CPU tensors), ``kernels/<name>/ref.py`` (the
plain PyTorch version of the same function) and the CUDA source under
``kernels/csrc/``.  ``kernels/build.py`` compiles the sources with
``nvcc`` at first use.

* flash_attention        — causal/windowed GQA prefill attention
* paged_decode_attention — GQA flash-decode over the paged KV pool, with
                           the single / blocked / fused (append+attend)
                           variants of the JAX package
"""
