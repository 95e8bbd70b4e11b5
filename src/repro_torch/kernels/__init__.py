"""The kernels of the port: hand-written CUDA for Hopper.

Layout per kernel: ``kernels/<name>/ops.py`` (the wrapper: checks its
inputs, launches the CUDA kernel for CUDA tensors and counts launches,
takes the plain version for CPU tensors), ``kernels/<name>/ref.py`` (the
plain PyTorch version of the same function) and the CUDA source under
``kernels/csrc/``.  ``kernels/build.py`` compiles the sources with
``nvcc`` at first use.

* flash_attention         — causal/windowed GQA prefill attention
* paged_decode_attention  — GQA flash-decode over the paged KV pool, with
                            the single / blocked / fused (append+attend)
                            variants of the JAX package
* decode_attention        — GQA flash-decode over a contiguous or ring
                            cache, returning the log-sum-exp state too
* shared_prefix_attention — Hydragen-style: one shared prefix against all
                            B*G query rows of a KV head (P split across
                            blocks, bf16 on the tensor cores), merged in
                            the kernel with a decode-attention pass over
                            each row's suffix
* rglru_scan              — the RG-LRU linear recurrence h = a*h + b
"""
