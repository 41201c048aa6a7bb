"""Device code of the port: PyTorch ops around hand-written CUDA kernels.

Decode: K1 ``lpc.lpc_scan`` (csrc/lpc_synth.cu) and K2
``rice_decode.rice_decode`` (csrc/rice_decode.cu). Encode: K3
``predict.predict`` (csrc/fir_predict.cu), K4 ``rice_search.rice_sums``
(csrc/rice_search.cu) and K5 ``bitpack.pack`` (csrc/bitpack.cu), around the
f64 analysis of ``exact.py``. Each wrapper launches its kernel for a CUDA
tensor, runs its plain PyTorch version for a CPU tensor, and counts its
kernel launches in ``<wrapper>.launches``. The kernels are built with nvcc
at first use (``build.py``).
"""
