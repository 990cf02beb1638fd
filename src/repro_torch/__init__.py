"""EntroLLM on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.  Its layout mirrors the JAX
package (``core``, ``kernels``, ``models``, ``configs``, ``serving``,
``launch``, ``obs``); ``convert`` carries parameter dicts across.  The decode
kernels are CUDA C++ under ``csrc/``, built at first use.
"""
