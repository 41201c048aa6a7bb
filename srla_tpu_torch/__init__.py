"""srla_tpu_torch — the SRLA codec's device path on PyTorch and CUDA.

A port of ``srla_tpu``'s device backend from JAX on a TPU to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). It holds the device
decode, ``decode(stream, device="cuda")``, and the exact device encode,
``encode(pcm, bits, rate, device="cuda")``, byte-identical to
``srla_tpu.encode(..., backend="exact")``. The host layer (stream format,
bit reader and writer, Huffman tables, native parameter parser and
assembler, host encoder for repairs) is shared with ``srla_tpu`` and
imported from it.

Importing this package never imports jax, and nothing under
``srla_tpu.kernels`` (that subpackage is the JAX/Pallas device code).
"""

from .decoder import SRLADecoder, decode
from .encoder import SRLAEncoder, encode

__all__ = ["decode", "encode", "SRLADecoder", "SRLAEncoder"]
__version__ = "0.1.0"
