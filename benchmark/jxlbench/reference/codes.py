"""The two entropy-code helpers the frozen decoder needs.

Frozen copy of jxl_tiny_tpu_torch/entropy/huffman.py (depths_to_bits,
_reverse_bits) and jxl_tiny_tpu_torch/entropy/uint_coder.py
(uint_decode_token) at commit 8ebce9c.
"""
import numpy as np


def depths_to_bits(depths) -> np.ndarray:
    """Canonical code assignment with bit reversal (enc_entropy_code.cc:296-322)."""
    depths = np.asarray(depths, np.uint8)
    bits = np.zeros(len(depths), np.uint16)
    bl_count = np.bincount(depths, minlength=16)[:16]
    bl_count[0] = 0
    next_code = np.zeros(16, np.uint32)
    code = 0
    for i in range(1, 16):
        code = (code + int(bl_count[i - 1])) << 1
        next_code[i] = code
    for i in range(len(depths)):
        d = int(depths[i])
        if d:
            bits[i] = _reverse_bits(d, int(next_code[d]))
            next_code[d] += 1
    return bits


def _reverse_bits(num_bits: int, value: int) -> int:
    r = 0
    for _ in range(num_bits):
        r = (r << 1) | (value & 1)
        value >>= 1
    return r


def uint_decode_token(token: int, reader) -> int:
    """Single-value inverse of the hybrid-uint split (4, 2, 0)."""
    if token < 16:
        return token
    n = token >> 2
    nbits = n - 2
    bits = reader.read(nbits)
    return (1 << n) | ((token & 3) << nbits) | bits
