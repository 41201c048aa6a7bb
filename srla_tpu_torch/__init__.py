"""srla_tpu_torch — the SRLA codec's device path on PyTorch and CUDA.

A port of ``srla_tpu``'s device backend from JAX on a TPU to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). It holds the device
decode, ``decode(stream, device="cuda")``, and the exact device encode,
``encode(pcm, bits, rate, device="cuda")``, byte-identical to
``srla_tpu.encode(..., backend="exact")``, and with ``approx=True``
``srla_tpu``'s f32 approximate encode (lossless, not byte-identical);
``hybrid=True`` splits each large group between the device and host
threads that steal blocks from its back (``srla_tpu``'s hybrid), with the
same bytes. ``host_decoder.decode(stream)`` decodes on the host alone
(``srla_tpu.decode``'s native whole-stream decode). The host layer (stream format,
bit reader and writer, Huffman tables, host DSP, the native library for
parsing and assembly, the exact host encoder for repairs and as the byte
reference) is the port's own: copies of ``srla_tpu``'s modules under the
same names, each naming its source. ``encode_files`` batches a corpus
across files, ``parallel`` splits the block axis over devices and fuses a
corpus into one decode, ``streaming`` and the block API decode block by
block, and ``SRLADecoder.decode_whole_device_resident`` decodes to PCM that
stays on the card, checked there against an expected PCM.

Nothing in this package imports jax or ``srla_tpu``.
"""

from .decoder import SRLADecoder, decode
from .encoder import SRLAEncoder, encode, encode_files

__all__ = ["decode", "encode", "encode_files", "SRLADecoder", "SRLAEncoder"]
__version__ = "0.1.0"
