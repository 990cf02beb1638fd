"""EntroLLM core (PyTorch port): mixed quantization, pluggable entropy coding
and streaming parallel decode.

The host-side codec layer (``bitstream``, ``entropy``, ``segmentation``,
``codecs``, ``spec``, ``store``) is a numpy copy of the JAX package's, so a
container written by either package reads in the other.  ``decode_backends``
routes each decode call to the numpy loop, the plain torch loop
(``decode_torch``) or the CUDA kernels (``repro_torch.kernels``).
"""
