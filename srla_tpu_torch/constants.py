"""SRLA bitstream format constants and parameter presets.

These values are normative for the on-disk ``.srl`` format. Reference points
(for parity checking only — the implementation here is original):
  - include/srla.h:7-25            (versions, header size, limits)
  - libs/srla_internal/include/srla_internal.h:14-35 (field bit widths)
  - libs/srla_internal/src/srla_internal.c:27-38     (presets, margin list)

The port's own copy of ``srla_tpu/constants.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

FORMAT_VERSION = 10
CODEC_VERSION = 18
HEADER_SIZE = 30
MAX_NUM_CHANNELS = 8
MAX_COEFFICIENT_ORDER = 255
MAX_LTP_ORDER = 3
NUM_PARAMETER_PRESETS = 7

BLOCK_SYNC_CODE = 0xFFFF

# Pre-emphasis
PREEMPHASIS_COEF_SHIFT = 4
NUM_PREEMPHASIS_FILTERS = 1

# LPC coefficient coding
LPC_COEFFICIENT_BITWIDTH = 8
RSHIFT_LPC_COEFFICIENT_BITWIDTH = 4
LPC_COEFFICIENT_ORDER_BITWIDTH = 8
LPC_RIDGE_REGULARIZATION_PARAMETER = 1e-5

# Long-term (pitch) prediction
LTP_ORDER_BITWIDTH = 1
LTP_PERIOD_BITWIDTH = 8
LTP_COEFFICIENT_BITWIDTH = 6
LTP_MIN_PERIOD = 8
LTP_MAX_PERIOD = LTP_MIN_PERIOD + (1 << LTP_PERIOD_BITWIDTH) - 2  # 262

# Residual coder (libs/srla_coder/src/srla_coder.c:17-24)
CODER_LOG2_MAX_NUM_PARTITIONS = 10
CODER_MAX_NUM_PARTITIONS = 1 << CODER_LOG2_MAX_NUM_PARTITIONS
CODER_RICE_PARAMETER_BITS = 5


class BlockDataType(IntEnum):
    COMPRESS = 0
    SILENT = 1
    RAW = 2


class ChProcessMethod(IntEnum):
    NONE = 0
    MS = 1
    LS = 2
    SR = 3


class CodeType(IntEnum):
    RICE = 0
    RECURSIVE_RICE = 1
    ALLZERO = 2


class OrderTactics(IntEnum):
    MAX_FIXED = 0
    BRUTEFORCE_SEARCH = 1
    BRUTEFORCE_ESTIMATION = 2


# Soft-threshold margins tried by the SVR coefficient refinement.
SVR_MARGIN_LIST = (0.0, 1.0 / 4096, 1.0 / 1024, 1.0 / 256, 1.0 / 64, 1.0 / 16)


@dataclass(frozen=True)
class ParameterPreset:
    max_num_parameters: int
    lpc_order_tactics: OrderTactics
    margin_list: tuple = SVR_MARGIN_LIST


# Presets 0..6 select max LPC order and the order-decision tactic.
PARAMETER_PRESETS = (
    ParameterPreset(0, OrderTactics.MAX_FIXED),
    ParameterPreset(8, OrderTactics.BRUTEFORCE_ESTIMATION),
    ParameterPreset(16, OrderTactics.BRUTEFORCE_ESTIMATION),
    ParameterPreset(32, OrderTactics.BRUTEFORCE_ESTIMATION),
    ParameterPreset(64, OrderTactics.BRUTEFORCE_ESTIMATION),
    ParameterPreset(128, OrderTactics.BRUTEFORCE_ESTIMATION),
    ParameterPreset(255, OrderTactics.BRUTEFORCE_ESTIMATION),
)
