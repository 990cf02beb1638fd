"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module per kernel.

Each module holds the kernel's wrapper (launches on a CUDA tensor, raises
on what the kernel does not take), its plain PyTorch version (what the
wrapper runs for a CPU tensor, and what ``chip_smoke.py`` holds the kernel
against on the card).  ``build`` compiles every source under
``repro_torch/csrc/`` into one library at first use, loads it and counts
each kernel's launches.
"""
