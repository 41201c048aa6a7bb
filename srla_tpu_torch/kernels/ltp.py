"""Long-term (pitch) prediction: K9, the decode's LTP synthesis, and K10, the
encode's pitch search, LTP solve and coefficient quantization, with the
integer LTP residual between them.

- ``ltp_synth`` is the twin of ``srla_tpu.kernels.decode2._ltp_pass``: on a
  CUDA tensor it launches ``csrc/ltp_synth.cu`` (K9), on a CPU tensor it
  runs ``ltp_synth_plain``.
- ``ltp_analyze`` is the twin of ``srla_tpu.kernels.exact._ltp_exact`` after
  its autocorrelation, in f64 with the JAX package's flags and margins: on a
  CUDA tensor it launches ``csrc/ltp_analyze.cu`` (K10), on a CPU tensor it
  runs ``ltp_analyze_plain``. Both carry one more step than the JAX twin:
  the host's peak scan also looks at lag 262 when the last segment starts at
  261 or when no segment is open after the scan (``lpc.c``'s detect loop
  runs once more from ``start = max_period``); ``_ltp_exact`` stops at 261
  and misses that candidate.
- ``ltp_predict`` is the twin of ``exact._ltp_predict_dev``, the integer
  LTP residual between the two: on a CUDA tensor it launches
  ``csrc/ltp_predict.cu`` (K18), on a CPU tensor it runs
  ``ltp_predict_plain``.

Parity targets: libs/lpc/src/lpc.c:1473-1649 (pitch and solve), the host's
``native_decoder.ltp_analyze_batch`` and ``dsp.pitch``; srla_decoder.c's LTP
synthesis.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import (LPC_RIDGE_REGULARIZATION_PARAMETER,
                         LTP_COEFFICIENT_BITWIDTH, LTP_MAX_PERIOD,
                         LTP_MIN_PERIOD)
from . import build
from .lpc import _MASK32, wrap32

LTP_LAGS = LTP_MAX_PERIOD + 1      # lags 0..262 of the pitch autocorrelation
LTP_COLS = LTP_MAX_PERIOD + 4      # + the host's zero tail (2) and a guard
_LTP_RSHIFT = LTP_COEFFICIENT_BITWIDTH - 1
_LTP_RING = 512                    # > the largest delay (263) + a step
_LTP_CHUNK = 7                     # the smallest delay - order + 1

# Margins, as in srla_tpu.kernels.exact (:942-947), and the f64 error they
# must cover. The port's lags come from autocorr.autocorr (K8 or its plain
# version; their sum orders' bounds are in exact.py, above _EPS_PREEMPH) and
# the host's from a real FFT; every lag differs from the exact value by at
# most 2^-42 of r0 (tests/test_torch_encode_margins.py pins it for the LTP
# lags too), so port and host lags differ by d <= 2^-41 r0.
#
# - Crossing signs, peak tests, running peaks, the 0.1 * r0 threshold and
#   the 0.9 * max ratio compare two lags (or a lag and 0, or a lag and a
#   product rounded once): the two sides' differences differ by at most
#   2 d + 2 ulp < 2^-39 r0, under _LTP_EPS_REL = 2^-36 of |r0|.
# - Cholesky pivots: the lags come from a windowed, circular (FFT-size)
#   autocorrelation, so the Toeplitz matrix is positive semi-definite and
#   the ridge lifts every eigenvalue, hence every pivot, to >= 1e-5 r0:
#   far above both the error and the 2^-36 r0 margin. The flag stays for
#   r0 near 0.
# - Coefficient rounding: x = A^-1 b moves by at most ||A^-1|| (|db| + |dA|
#   |x|) <= T * 2^-42 r0 * (2 + 3 sum |x|), T = ||L^-1||_F^2 >= ||A^-1||_2
#   from the Cholesky factor L; times 32 in quantized units. The JAX margin
#   of 1e-6 units covers it while T r0 stays under ~1e3; rows as ill
#   conditioned as the ridge allows (T r0 up to 1e5) need more, so the port
#   widens it to 32 * T * |r0| * (2 + 3 sum |x|) * 2^-40 (_LTP_KAPPA_SCALE:
#   four times the bound, for the rounding of both solves) where that is
#   larger. Every flag of _ltp_exact is raised; the widened one only adds.
_LTP_EPS_REL = 2.0 ** -36          # compare margins, relative to |r0|
_EPS_LTP_QUANT = 1e-6              # quantized-units rounding margin
_LTP_KAPPA_SCALE = 2.0 ** -40      # conditioning allowance of the rounding
_PITCH_MAX_CAND = 20               # MAX_NUM_PITCH_CANDIDATES
_PITCH_THRESH = 0.1                # PITCH_AUTOCORR_THRESHOLD
_PITCH_RATIO = 0.9                 # PITCH_RATIO_VS_MAX_THRESHOLD
_FLT_MIN = 1.1754943508222875e-38
_F64 = torch.float64


# ---------------------------------------------------------------------------
# K10: pitch search, LTP solve and quantization (encode)
# ---------------------------------------------------------------------------

def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    r = torch.floor(x.abs() + 0.5)
    return torch.where(x < 0, -r, r)


def pitch_scan_plain(ac: torch.Tensor):
    """The pitch search of K10's plain version (``_ltp_exact:983-1062``):
    the lag scan as a Python loop over the lags, vectorised over rows, then
    the 0.1 * r0 threshold and the first candidate at 0.9 of the largest
    peak, every comparison with its margin flag, in f64. ac (V, LTP_COLS)
    f64. Returns (periods (V,) int64 before the r0 and order guards, 0 =
    none; risky (V,) bool)."""
    V = ac.shape[0]
    dev = ac.device
    ac0 = ac[:, 0]
    eps = ac0.abs() * _LTP_EPS_REL

    def near(a, b):
        return (a - b).abs() < eps

    zero_b = torch.zeros(V, dtype=torch.bool, device=dev)
    inseg, enter, risky = zero_b, zero_b, zero_b
    sp = torch.zeros(V, dtype=_F64, device=dev)
    mp = torch.zeros(V, dtype=_F64, device=dev)
    sidx = torch.zeros(V, dtype=torch.int64, device=dev)
    ncand = torch.zeros(V, dtype=torch.int64, device=dev)
    cands = torch.zeros((V, _PITCH_MAX_CAND), dtype=torch.int64, device=dev)
    slot = torch.arange(_PITCH_MAX_CAND, device=dev)[None, :]

    def peak_test(j, live, sp, sidx, risky):
        am1, a0, ap1 = ac[:, j - 1], ac[:, j], ac[:, j + 1]
        pk = live & (a0 > am1) & (a0 > ap1)
        risky = risky | (live & (near(a0, am1) | near(a0, ap1)))
        better = pk & (a0 > sp)
        risky = risky | (pk & near(a0, sp))
        return (torch.where(better, a0, sp), torch.where(better, j, sidx),
                risky)

    def append(fin, sp, sidx, cands, mp, ncand, risky):
        cands = torch.where(fin[:, None] & (slot == ncand[:, None]),
                            sidx[:, None], cands)
        risky = risky | (fin & near(sp, mp))
        mp = torch.where(fin & (sp > mp), sp, mp)
        return cands, mp, ncand + fin.long(), risky

    for j in range(LTP_MIN_PERIOD, LTP_MAX_PERIOD):
        am1, a0, ap1 = ac[:, j - 1], ac[:, j], ac[:, j + 1]
        risky = risky | (am1.abs() < eps) | (a0.abs() < eps)
        enter = ~inseg & (ncand < _PITCH_MAX_CAND) & (am1 < 0) & (a0 > 0)
        sp = torch.where(enter, 0.0, sp)
        sidx = torch.where(enter, 0, sidx)
        inseg = inseg | enter
        sp, sidx, risky = peak_test(j, inseg, sp, sidx, risky)
        # Segment close: the first pos -> neg crossing from start + 1 on.
        open_ = inseg & ~enter
        close = open_ & (a0 > 0) & (ap1 < 0) if j < LTP_MAX_PERIOD - 1 \
            else zero_b
        risky = risky | (open_ & ((a0.abs() < eps) | (ap1.abs() < eps)))
        cands, mp, ncand, risky = append(close & (sidx != 0), sp, sidx,
                                         cands, mp, ncand, risky)
        inseg = inseg & ~close
    # The host's scan reaches lag 262 from a segment that starts at 261,
    # and from a fresh one when no crossing is left (start = 262).
    tail = (inseg & enter) | (~inseg & (ncand < _PITCH_MAX_CAND))
    fresh = tail & ~inseg
    sp = torch.where(fresh, 0.0, sp)
    sidx = torch.where(fresh, 0, sidx)
    sp, sidx, risky = peak_test(LTP_MAX_PERIOD, tail, sp, sidx, risky)
    # The unclosed trailing segment still appends its peak.
    cands, mp, ncand, risky = append((inseg | tail) & (sidx != 0), sp, sidx,
                                     cands, mp, ncand, risky)

    # Threshold and the first candidate at 0.9 of the largest peak.
    thresh = ac0 * _PITCH_THRESH
    ok = (ncand > 0) & ~(mp < thresh)
    risky = risky | near(mp, thresh)
    ratio = (mp * _PITCH_RATIO)[:, None]
    cv = ac.gather(1, cands)
    live = slot < ncand[:, None]
    qual = live & ~(cv < ratio)
    risky = risky | (live & ((cv - ratio).abs() < eps[:, None])).any(dim=1)
    first = qual.to(torch.uint8).argmax(dim=1)
    period = torch.where(ok & qual.any(dim=1),
                         cands.gather(1, first[:, None])[:, 0], 0)
    return period, risky


def ltp_solve_plain(ac: torch.Tensor, period: torch.Tensor, order: int,
                    risky: torch.Tensor):
    """The rest of K10's plain version (``_ltp_exact:1063-1125``): the r0
    and short-period guards, the ridge Cholesky of order 1 or 3 and the
    quantization, every decision with its margin flag, in f64. period (V,)
    int64 from pitch_scan_plain. Returns (periods (V,) int32, 0 = off; coefs
    (V, order) int32 in emission (reversed) order; risky (V,) bool)."""
    ac0 = ac[:, 0]
    zero_b = torch.zeros_like(risky)
    # |r0| <= FLT_MIN and the short-period guard.
    risky = risky | ((ac0.abs() - _FLT_MIN).abs() < 1e-38)
    period = torch.where(ac0.abs() <= _FLT_MIN, 0, period)
    period = torch.where(period < (order // 2) + 1, 0, period)

    # Ridge Cholesky of order 1 or 3 in the host's operation order
    # (dsp/pitch.py cholesky_decompose / cholesky_solve), 1/sqrt for libm's
    # pow(s, -0.5).
    a0r = ac0 * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
    eps_pos = a0r.abs() * _LTP_EPS_REL

    def rhs(i):
        idx = (period - (order // 2) + i).clamp(0, ac.shape[1] - 1)
        return ac.gather(1, idx[:, None])[:, 0]

    def pivot(s, singular, risky):
        return (singular | (s <= 0), risky | (s.abs() < eps_pos),
                torch.ones_like(s) / torch.sqrt(s))

    singular, risky, d0 = pivot(a0r, zero_b, risky)
    if order == 1:
        x = [(rhs(0) * d0) * d0]
        tr = d0 * d0
    else:
        r1, r2 = ac[:, 1], ac[:, 2]
        l10 = r1 * d0
        l20 = r2 * d0
        singular, risky, d1 = pivot(a0r - l10 * l10, singular, risky)
        l21 = (r1 - l10 * l20) * d1
        singular, risky, d2 = pivot((a0r - l21 * l21) - l20 * l20, singular,
                                    risky)
        y0 = rhs(0) * d0
        y1 = (rhs(1) - l10 * y0) * d1
        y2 = ((rhs(2) - l21 * y1) - l20 * y0) * d2
        x2 = y2 * d2
        x1 = (y1 - l21 * x2) * d1
        x0 = ((y0 - l10 * x1) - l20 * x2) * d0
        x = [x0, x1, x2]
        # ||L^-1||_F^2, the conditioning of the rounding allowance.
        m10 = (l10 * d0) * d1
        m20 = ((l10 * l21) * d1 - l20) * (d0 * d2)
        m21 = (l21 * d1) * d2
        tr = ((((d0 * d0 + m10 * m10) + d1 * d1) + m20 * m20) + m21 * m21) \
            + d2 * d2
    period = torch.where(singular, 0, period)
    sx = x[0].abs()
    for c in x[1:]:
        sx = sx + c.abs()
    eps_q = torch.clamp((((32.0 * tr) * ac0.abs()) * (2.0 + 3.0 * sx))
                        * _LTP_KAPPA_SCALE, min=_EPS_LTP_QUANT)

    # Quantize: round-half-away(c * 32), clip to [-32, 31], emission order
    # reversed.
    on = period > 0
    q = []
    for c in x:
        scaled = c * 32.0
        ax = scaled.abs()
        risky = risky | (on & (((ax - torch.floor(ax)) - 0.5).abs() < eps_q))
        q.append(torch.where(on, _round_half_away(scaled).clamp(-32, 31),
                             0.0))
    coefs = torch.stack(q[::-1], dim=1).to(torch.int32)
    return period.to(torch.int32), coefs, risky


def ltp_analyze_plain(ac: torch.Tensor, order: int):
    """Plain PyTorch version of K10 (``_ltp_exact:983-1125``): the pitch
    search, then the solve and quantization. ac (V, LTP_COLS) f64: lags
    0..262, then zeros. Returns (periods (V,) int32, 0 = off; coefs (V,
    order) int32 in emission (reversed) order; risky (V,) bool)."""
    period, risky = pitch_scan_plain(ac)
    return ltp_solve_plain(ac, period, order, risky)


def ltp_analyze(ac: torch.Tensor, order: int):
    """ac (V, LTP_COLS) f64 pitch lags (``exact.ltp_lags``); order 1 or 3.
    Returns (periods (V,) int32, coefs (V, order) int32 reversed, risky
    (V,) bool).

    CUDA tensors go through the kernel (``ltp_analyze.launches`` counts its
    launches); CPU tensors go through ``ltp_analyze_plain``."""
    if order not in (1, 3):
        raise ValueError(f"ltp_analyze: order must be 1 or 3, got {order}")
    if ac.dim() != 2 or ac.shape[1] != LTP_COLS:
        raise ValueError(f"ltp_analyze: ac must be (V, {LTP_COLS}), got "
                         f"{tuple(ac.shape)}")
    if ac.device.type == "cpu":
        return ltp_analyze_plain(ac, order)
    if ac.device.type != "cuda":
        raise ValueError(f"ltp_analyze: no kernel for device {ac.device}")
    if ac.dtype != _F64 or not ac.is_contiguous():
        raise ValueError("ltp_analyze: ac must be a contiguous float64 "
                         "tensor")
    V = ac.shape[0]
    period = torch.empty(V, dtype=torch.int32, device=ac.device)
    coefs = torch.empty((V, order), dtype=torch.int32, device=ac.device)
    risky = torch.empty(V, dtype=torch.bool, device=ac.device)
    if V == 0:
        return period, coefs, risky
    lib = _lib("ltp_analyze", "srla_ltp_analyze", 4, 2)
    stream = torch.cuda.current_stream(ac.device).cuda_stream
    err = lib.srla_ltp_analyze(ac.data_ptr(), period.data_ptr(),
                               coefs.data_ptr(), risky.data_ptr(), V, order,
                               stream)
    build.check(err, "ltp_analyze")
    ltp_analyze.launches += 1
    return period, coefs, risky


ltp_analyze.launches = 0


def ltp_predict_plain(work: torch.Tensor, coefs: torch.Tensor,
                      periods: torch.Tensor, order: int) -> torch.Tensor:
    """Plain PyTorch version of K18 (``exact._ltp_predict_dev``): order
    gathers in int64, then the wrap to int32."""
    V, n = work.shape
    delay = periods.long() + (order >> 1)
    s = torch.arange(n, device=work.device)[None, :]
    x = work.long()
    acc = torch.full((V, n), 1 << (_LTP_RSHIFT - 1), dtype=torch.int64,
                     device=work.device)
    for i in range(order):
        idx = (s - delay[:, None] + i).clamp(0, n - 1)
        acc = acc + coefs[:, i:i + 1].long() * torch.gather(x, 1, idx)
    on = (periods > 0)[:, None] & (s >= (delay + 1)[:, None])
    pred = wrap32(acc) >> _LTP_RSHIFT
    return torch.where(on, wrap32(x - pred), x).to(torch.int32)


def ltp_predict(work: torch.Tensor, coefs: torch.Tensor,
                periods: torch.Tensor, order: int) -> torch.Tensor:
    """The integer LTP residual (``exact._ltp_predict_dev``): out[s] = x[s]
    - ((16 + sum_i c[i] * x[s - delay + i]) >> 5) for s >= delay + 1,
    delay = period + order // 2, x the unfiltered input throughout; rows
    with period 0 pass through. work (V, n) int32, coefs (V, >= order)
    int32 reversed, periods (V,) int32; order 1 or 3. Wrapping int32.

    CUDA tensors go through the kernel K18 (``csrc/ltp_predict.cu``;
    ``ltp_predict.launches`` counts its launches); CPU tensors go through
    ``ltp_predict_plain``."""
    if work.device.type == "cpu":
        return ltp_predict_plain(work, coefs, periods, order)
    dev = work.device
    if dev.type != "cuda":
        raise ValueError(f"ltp_predict: no kernel for device {dev}")
    V, n = work.shape
    if order not in (1, 3) or coefs.dim() != 2 or coefs.shape[1] < order:
        raise ValueError(f"ltp_predict: order {order} (1 or 3) with coefs "
                         f"{tuple(coefs.shape)}")
    build.check_arg("ltp_predict", "work", work, (V, n), dev)
    build.check_arg("ltp_predict", "coefs", coefs, (V, coefs.shape[1]), dev)
    build.check_arg("ltp_predict", "periods", periods, (V,), dev)
    out = torch.empty((V, n), dtype=torch.int32, device=dev)
    if V == 0 or n == 0:
        return out
    lib = _lib("ltp_predict", "srla_ltp_predict", 4, 4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.srla_ltp_predict(work.data_ptr(), coefs.data_ptr(),
                               periods.data_ptr(), out.data_ptr(), V, n,
                               order, coefs.shape[1], stream)
    build.check(err, "ltp_predict")
    ltp_predict.launches += 1
    return out


ltp_predict.launches = 0


# ---------------------------------------------------------------------------
# K9: LTP synthesis (decode)
# ---------------------------------------------------------------------------

def ltp_synth_plain(v: torch.Tensor, lorders: torch.Tensor,
                    lperiods: torch.Tensor, lcoefs: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Plain PyTorch version of K9 (``decode2._ltp_pass``):
    ``y[s] = v[s] + ((half + sum_i c_i * y[s - delay + i]) >> 5)`` for
    ``s >= delay + 1``, ``delay = period + order // 2``; rows with period
    or order 0 pass through. The delay is at least 8, so each step
    resolves ``_LTP_CHUNK`` samples from a ring of final outputs (slot 511
    newest)."""
    R = v.shape[0]
    dev = v.device
    maxo = lcoefs.shape[1]
    delay = lperiods.long() + (lorders.long() >> 1)
    on = (lperiods > 0) & (lorders > 0)
    half = 1 << (_LTP_RSHIFT - 1)
    nchunks = -(-n // _LTP_CHUNK)
    vp = torch.nn.functional.pad(v.long(), (0, nchunks * _LTP_CHUNK - n))
    j = torch.arange(_LTP_CHUNK, device=dev)[None, :, None]
    i = torch.arange(maxo, device=dev)[None, None, :]
    slot = (_LTP_RING + j - delay[:, None, None] + i).clamp(0, _LTP_RING - 1)
    slot = slot.reshape(R, _LTP_CHUNK * maxo)
    imask = (i < lorders.long()[:, None, None]).expand(R, _LTP_CHUNK, maxo)
    cexp = lcoefs.long().repeat(1, _LTP_CHUNK) * imask.reshape(R, -1)
    ring = torch.zeros((R, _LTP_RING), dtype=torch.int64, device=dev)
    lane = torch.arange(_LTP_CHUNK, device=dev)[None, :]
    outs = []
    for t in range(nchunks):
        vx = vp[:, t * _LTP_CHUNK:(t + 1) * _LTP_CHUNK]
        g = torch.gather(ring, 1, slot)
        dot = ((g * cexp) & _MASK32).reshape(R, _LTP_CHUNK, maxo).sum(dim=2)
        yv = wrap32(vx + (wrap32(dot + half) >> _LTP_RSHIFT))
        sidx = t * _LTP_CHUNK + lane
        use = on[:, None] & (sidx >= (delay + 1)[:, None]) & (sidx < n)
        y = torch.where(use, yv, vx)
        ring = torch.cat([ring[:, _LTP_CHUNK:], y], dim=1)
        outs.append(y)
    out = torch.cat(outs, dim=1)[:, :n]
    return torch.where(on[:, None], out, v.long()).to(torch.int32)


def ltp_synth(v: torch.Tensor, lorders: torch.Tensor, lperiods: torch.Tensor,
              lcoefs: torch.Tensor, n: int) -> torch.Tensor:
    """v (R, n) int32 LPC outputs; lorders, lperiods (R,) int32 (periods 0
    or >= 8, as the format codes them); lcoefs (R, L) int32, L <= 3.
    Returns (R, n) int32.

    CUDA tensors go through the kernel (``ltp_synth.launches`` counts its
    launches); CPU tensors go through ``ltp_synth_plain``."""
    if v.device.type == "cpu":
        return ltp_synth_plain(v, lorders, lperiods, lcoefs, n)
    if v.device.type != "cuda":
        raise ValueError(f"ltp_synth: no kernel for device {v.device}")
    R = v.shape[0]
    L = lcoefs.shape[1] if lcoefs.dim() == 2 else -1
    if not 1 <= L <= 3:
        raise ValueError(f"ltp_synth: lcoefs must be (R, 1..3), got "
                         f"{tuple(lcoefs.shape)}")
    build.check_arg("ltp_synth", "v", v, (R, n), v.device)
    build.check_arg("ltp_synth", "lorders", lorders, (R,), v.device)
    build.check_arg("ltp_synth", "lperiods", lperiods, (R,), v.device)
    build.check_arg("ltp_synth", "lcoefs", lcoefs, (R, L), v.device)
    out = torch.empty((R, n), dtype=torch.int32, device=v.device)
    if R == 0 or n == 0:
        return out
    lib = _lib("ltp_synth", "srla_ltp_synth", 5, 3)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.srla_ltp_synth(v.data_ptr(), lorders.data_ptr(),
                             lperiods.data_ptr(), lcoefs.data_ptr(),
                             out.data_ptr(), R, n, L, stream)
    build.check(err, "ltp_synth")
    ltp_synth.launches += 1
    return out


ltp_synth.launches = 0


def _lib(name: str, fn_name: str, nptr: int, nint: int) -> ctypes.CDLL:
    """The kernel's library; its entry takes nptr pointers, nint ints and
    the stream."""
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint \
            + [ctypes.c_void_p]
    return lib
