"""Device code of the port: PyTorch ops around hand-written CUDA kernels.

Decode: K2 ``rice_decode.rice_decode`` (csrc/rice_decode.cu), K1
``lpc.lpc_scan_coefs`` (csrc/lpc_synth.cu; ``lpc.lpc_scan`` is its entry
on aligned coefficients), K9 ``ltp.ltp_synth`` (csrc/ltp_synth.cu) and
K19 ``decode2.synth_tail`` (csrc/synth_tail.cu: the stereo inverse and
offset shift); the decode to device-resident PCM checks each
group with K13 ``verify.verify_blocks`` (csrc/verify.cu). Encode, composed
by ``exact.py``: K16 ``preemphasis.variant_preemphasis``
(csrc/preemphasis.cu: the variant stack and pre-emphasis), K8
``autocorr.autocorr`` (csrc/autocorr.cu), K10 ``ltp.ltp_analyze``
(csrc/ltp_analyze.cu), K18 ``ltp.ltp_predict`` (csrc/ltp_predict.cu), K7
``levinson.lpc_analyze`` (csrc/lpc_analyze.cu), K3 ``predict.predict``
(csrc/fir_predict.cu), K4 ``rice_search.rice_search``
(csrc/rice_search.cu: the whole Rice parameter search), K17
``select.select_blocks`` and ``select.measure_blocks`` (csrc/select.cu:
the bit accounting and stereo selection) and K5
``bitpack.pack_residual_sections`` (csrc/bitpack.cu). The f32
approximate encode, composed by ``encode.py``, runs K16's f32 entry
``preemphasis.variant_preemphasis_f32``, K18 (with LTP), K14
``lpc_f32.lpc_analyze_f32`` (csrc/lpc_analyze_f32.cu), K3, K15
``rice_cost.rice_cost`` (csrc/rice_cost.cu), K17 and K5. Each wrapper
launches its kernel for a CUDA tensor, runs its plain PyTorch version for
a CPU tensor, and counts its kernel launches in ``<wrapper>.launches``. The kernels are built with nvcc
at first use (``build.py``).
"""
