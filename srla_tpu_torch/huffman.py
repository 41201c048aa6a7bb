"""Static Huffman coding for LPC coefficient symbols.

Tree construction must match the stream format exactly: repeated scan for the
two smallest counts (strict ``<``, lowest index wins), parents appended after
the leaves, left child = first minimum = bit 0. Zero counts are bumped to 1.
Format parity: libs/static_huffman/src/static_huffman.c:28-131.

Encoding here is table-driven and vectorized (symbol -> (code, length) arrays);
decoding uses a two-level lookup table instead of a per-bit tree walk.

The port's own copy of ``srla_tpu/huffman.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .freq_tables import PARAMETER_FREQUENCY_TABLE, SUM_PARAMETER_FREQUENCY_TABLE


class HuffmanCodebook:
    def __init__(self, counts):
        num_symbols = len(counts)
        work = [max(1, int(c)) for c in counts] + [0] * num_symbols
        node0 = [0] * (2 * num_symbols)
        node1 = [0] * (2 * num_symbols)
        free_node = num_symbols
        while True:
            min1 = min2 = None
            for node in range(free_node):
                c = work[node]
                if c <= 0:
                    continue
                if min1 is None or c < work[min1]:
                    min2 = min1
                    min1 = node
                elif min2 is None or c < work[min2]:
                    min2 = node
            if min2 is None:
                break
            work[free_node] = work[min1] + work[min2]
            work[min1] = work[min2] = 0
            node0[free_node] = min1
            node1[free_node] = min2
            free_node += 1
        self.num_symbols = num_symbols
        self.root = free_node - 1
        self.node0 = node0
        self.node1 = node1

        # Code assignment: DFS, 0-branch first.
        codes = np.zeros(num_symbols, dtype=np.uint64)
        lengths = np.zeros(num_symbols, dtype=np.int64)
        stack = [(self.root, 0, 0)]
        while stack:
            node, code, depth = stack.pop()
            if node < num_symbols:
                codes[node] = code
                lengths[node] = depth
                continue
            stack.append((node1[node], (code << 1) | 1, depth + 1))
            stack.append((node0[node], code << 1, depth + 1))
        self.codes = codes
        self.lengths = lengths
        self.max_length = int(lengths.max())

        # Decode tables: primary K-bit lookup; escapes point into a dense
        # secondary table keyed by the remaining (max_length - K) bits.
        K = min(12, self.max_length)
        self._primary_bits = K
        prim_sym = np.full(1 << K, -1, dtype=np.int32)
        prim_len = np.zeros(1 << K, dtype=np.int32)
        long_syms = []
        for s in range(num_symbols):
            L = int(lengths[s])
            c = int(codes[s])
            if L <= K:
                base = c << (K - L)
                prim_sym[base:base + (1 << (K - L))] = s
                prim_len[base:base + (1 << (K - L))] = L
            else:
                long_syms.append(s)
        self._prim_sym = prim_sym
        self._prim_len = prim_len
        self._long = [(int(codes[s]), int(lengths[s]), s) for s in long_syms]

    def decode_one(self, reader) -> int:
        """Decode a single symbol from a BitReader."""
        K = self._primary_bits
        bits = reader._bits
        pos = reader.pos
        avail = len(bits) - pos
        take = min(K, avail)
        peek = 0
        for b in bits[pos:pos + take]:
            peek = (peek << 1) | int(b)
        peek <<= (K - take)
        sym = int(self._prim_sym[peek])
        if sym >= 0:
            reader.pos = pos + int(self._prim_len[peek])
            return sym
        # Long code: extend bit by bit over the long-code list.
        code, length = 0, 0
        for b in bits[pos:]:
            code = (code << 1) | int(b)
            length += 1
            for c, L, s in self._long:
                if L == length and c == code:
                    reader.pos = pos + length
                    return s
        raise ValueError("invalid Huffman code")


@lru_cache(maxsize=None)
def parameter_codebook() -> HuffmanCodebook:
    return HuffmanCodebook(PARAMETER_FREQUENCY_TABLE)


@lru_cache(maxsize=None)
def sum_parameter_codebook() -> HuffmanCodebook:
    return HuffmanCodebook(SUM_PARAMETER_FREQUENCY_TABLE)
