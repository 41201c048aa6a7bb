"""The least time an H100 could take for the work of the port's kernels,
from the shapes of a request: the benchmark's frozen yardstick.

``bound`` and the peak rates are frozen copies of ``chip_smoke.py``'s
(``bound``, ``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``, ``F64_OPS_PER_S``,
``F64_TENSOR_OPS_PER_S``), and each ``kN`` function freezes the count of
its ``kN_bound`` or of the phase that states it: each input byte read once,
each output byte written once, and the operations the algorithm needs.
Where the program's count reads a value that only the kernel's own inputs
hold (the orders of rows the stream does not keep, the recursive rows),
the count here takes the smallest such value, so a least time here is
never above the program's: a share of it cannot pass 100 % unless the
measured time leaves out work.

The counts take the shapes a request's stream shows: its COMPRESS blocks
grouped by length, their channel orders and stereo methods and the bytes
of their payloads (``Group``). On the encode path the group's analysis
rows are the variant stack's: mid, side and each channel for stereo.
"""

from __future__ import annotations

from dataclasses import dataclass, field

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
# H100 SXM: 132 SMs, 64 INT32 results per clock per SM for add, shift,
# logic and multiply-add (compute capability 9.0), 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# f64 outside the tensor cores: 34 TFLOP/s (data sheet), a fused
# multiply-add counted as two; on the f64 tensor cores (DMMA), 67 TFLOP/s.
F64_OPS_PER_S = 34e12
F64_TENSOR_OPS_PER_S = 67e12


def bound(moved_bytes: float, ops: float,
          ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops_ms=t_ops)


@dataclass
class Group:
    """The COMPRESS blocks of one length in one request's stream."""
    n: int                       # samples a block
    blocks: int                  # B
    channels: int                # C
    payload_bytes: int           # the blocks' payloads, all together
    order_sum: int               # the channel orders, summed
    methods: list = field(default_factory=list)   # a stereo method a block


def variants(B: int, C: int) -> int:
    """The analysis rows of B blocks: mid and side, then each channel."""
    return B * (C + 2 if C >= 2 else C)


def max_porder(n: int) -> int:
    p = 0
    while n % (1 << (p + 1)) == 0 and p < 10:
        p += 1
    return p


# Encode: one encode call of a group (kernels/exact.py encode_blocks).

def k16(g: Group, elem: int) -> dict:
    """K16 (chip_smoke.k16_bound with spans and flags): the group's samples
    read once with their span offsets, the (V, n) rows and three fields a
    row written once; 13 integer instructions a row sample."""
    V = variants(g.blocks, g.channels)
    moved = (g.blocks * g.channels * g.n * elem + 8 * g.blocks
             + V * g.n * 4 + 9 * V)
    return bound(moved, 13 * V * g.n)


def k8(g: Group, lags: int) -> dict:
    """K8 (phase 10): the rows and the window read once, the lags written
    once; a multiply and an add in f64 for every product of two samples of
    a row at each lag (the wrapped products of the FFT size left out)."""
    V = variants(g.blocks, g.channels)
    pairs = sum(g.n - k for k in range(lags))
    return bound(V * g.n * 4 + g.n * 8 + V * lags * 8, 2 * V * pairs,
                 F64_TENSOR_OPS_PER_S)


def k7(g: Group, M: int) -> dict:
    """K7 (phase 11's ops7): the lags read once, orders, shifts,
    coefficients and the flag written once; per row the recursion to M,
    the order choice, and the quantization of the order chosen (the
    smallest, 0, for rows the stream does not keep)."""
    V = variants(g.blocks, g.channels)
    first = sum(4 * m + 7 for m in range(2, M + 1))
    ops = V * (first + 30 * M) + 8 * g.order_sum
    return bound(V * (M + 1) * 8 + V * (4 + 4 + 4 * M + 1), ops,
                 F64_OPS_PER_S)


def k3(g: Group) -> dict:
    """K3 (phase 5): the rows and their taps read once, the residual
    written once; a multiply-add per tap and sample (the kept rows'
    orders; 0 for the others) and 3 a sample."""
    V = variants(g.blocks, g.channels)
    return bound(2 * V * g.n * 4 + 4 * g.order_sum,
                 g.n * (g.order_sum + 3 * V))


def k4(g: Group) -> dict:
    """K4 (chip_smoke.k4_bound): the residual read once, the outputs (a
    code type, an order, the bits, a flag and 1024 ks as int64) written
    once; 5 instructions a sample once, then 2 a sample and order (the
    plain rows' count, the smaller)."""
    V = variants(g.blocks, g.channels)
    P = max_porder(g.n) + 1
    return bound(V * g.n * 4 + V * (4 * 4 + 1024 * 8), (5 * V + 2 * V * P)
                 * g.n)


def k17(g: Group, M: int) -> dict:
    """K17 (chip_smoke.k17_bound, the kept rows' coefficients): each
    row's section bits, order, period and flags and its coefficients read
    once, the choice written once; 12 a coefficient, 30 a row."""
    V = variants(g.blocks, g.channels)
    moved = V * (8 + 4 + 4 + 2) + 4 * g.order_sum + g.blocks * 16
    return bound(moved, 12 * g.order_sum + 30 * V)


def k5(g: Group) -> dict:
    """K5's row entry (chip_smoke.k5_rows_bound): the chosen rows'
    residuals read once, 40 bytes of fields a row, the words written
    once; 15 operations a sample."""
    rows = g.blocks * g.channels
    return bound(4 * rows * g.n + 40 * rows + g.payload_bytes,
                 15 * rows * g.n)


def encode_group(g: Group, elem: int, M: int) -> dict:
    """The least ms of each encode kernel on one group, by kernel."""
    return {"K16": k16(g, elem)["bound_ms"], "K8": k8(g, M + 1)["bound_ms"],
            "K7": k7(g, M)["bound_ms"], "K3": k3(g)["bound_ms"],
            "K4": k4(g)["bound_ms"], "K17": k17(g, M)["bound_ms"],
            "K5": k5(g)["bound_ms"]}


# Decode: kernels/decode2.py decode_blocks on one group.

def k2(g: Group) -> dict:
    """K2 (phase 2): the stream's words and each block's start read once,
    the samples written once; a peek, a count of leading zeros, a shift
    and the unzigzag a sample."""
    S = g.blocks * g.channels * g.n
    return bound(g.payload_bytes + 8 * g.blocks + 4 * S, 4 * S)


def k1(g: Group) -> dict:
    """K1's coefficient entry (phase 17): residuals, orders, shifts and the
    de-emphasis scalars read once, the taps the orders read, the samples
    written once; a multiply-add per tap and sample and 6 a row sample."""
    R = g.blocks * g.channels
    return bound(4 * R * g.n * 2 + R * 16 + 4 * g.order_sum,
                 g.n * (g.order_sum + 6 * R))


def k19(g: Group, lshift: int) -> dict:
    """K19 (chip_smoke.k19_bound): rows 0 and 1 read where a block's
    method changes them and each changed row written (every row when
    lshift is not 0); four instructions a sample of each changed pair."""
    n, B, C = g.n, g.blocks, g.channels
    if lshift != 0:
        rows_read = rows_written = B * C
        pairs = B if C >= 2 else 0
    elif C >= 2:
        m = g.methods
        changed = sum(1 for x in m if 1 <= x <= 3)
        rows_read = 2 * changed
        rows_written = 2 * sum(1 for x in m if x == 1) + sum(
            1 for x in m if x in (2, 3))
        pairs = changed
    else:
        rows_read = rows_written = pairs = 0
    return bound(4 * n * (rows_read + rows_written), 4 * n * pairs)


def decode_group(g: Group, lshift: int) -> dict:
    return {"K2": k2(g)["bound_ms"], "K1": k1(g)["bound_ms"],
            "K19": k19(g, lshift)["bound_ms"]}


# The kernels' names in a device trace (the __global__ functions of
# srla_tpu_torch/kernels/csrc), by the kernel they belong to.
KERNEL_NAMES = {
    "preemphasis_kernel": "K16", "autocorr_kernel": "K8",
    "lpc_analyze_kernel": "K7", "lpc_quantize_kernel": "K7",
    "fir_predict_kernel": "K3", "rice_search_rows": "K4",
    "select_kernel": "K17", "pack_sections_kernel": "K5",
    "bitpack_kernel": "K5", "rice_decode_kernel": "K2",
    "lpc_synth_kernel": "K1", "synth_tail_kernel": "K19",
    "ltp_synth_kernel": "K9",
}


def kernel_of(name: str) -> str | None:
    """The kernel a device trace's event name belongs to, or None."""
    for key, k in KERNEL_NAMES.items():
        if key in name:
            return k
    return None
