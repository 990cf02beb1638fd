"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module per kernel
family: ``huffman_decode`` and ``ans_decode`` (``csrc/entropy_decode.cu``),
``fused_decode_matmul`` (``csrc/fused_decode_matmul.cu``) and
``dequant_matmul`` (``csrc/dequant_matmul.cu``).

Each module holds the kernel's wrapper (launches on a CUDA tensor, raises
on what the kernel does not take), its plain PyTorch version (what the
wrapper runs for a CPU tensor, and what ``chip_smoke.py`` holds the kernel
against on the card).  ``ops`` holds the public wrappers and the K-packing
utilities (the JAX package's ``kernels/ops.py``), ``ref`` the oracles.
``build`` compiles every source under ``repro_torch/csrc/`` into one
library at first use, loads it and counts each kernel's launches.
"""
