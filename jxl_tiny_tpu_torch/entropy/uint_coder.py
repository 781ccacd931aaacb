"""Hybrid-uint token split, vectorized.

Configuration split_exponent=4, msb_in_token=2, lsb_in_token=0, matching the
reference (encoder/token.h:24-48, enc_entropy_code.cc:430-432): values < 16 are
coded directly; larger values as token (n<<2)+(top 2 mantissa bits) plus n-2
raw LSBs.
"""
import numpy as np


def uint_encode(values):
    """values: uint array -> (token, nbits, bits) arrays (all int32/uint32)."""
    v = np.asarray(values, np.uint32)
    small = v < 16
    # floor(log2(v)) for v >= 16; keep safe for small values.
    vv = np.maximum(v, 16)
    n = np.frexp(vv.astype(np.float64))[1].astype(np.int32) - 1  # floor log2
    token_big = (n << 2) + ((vv >> np.maximum(n - 2, 0).astype(np.uint32)) & 3)
    nbits_big = n - 2
    bits_big = vv & ((np.uint32(1) << nbits_big.astype(np.uint32)) - np.uint32(1))
    token = np.where(small, v.astype(np.int32), token_big)
    nbits = np.where(small, 0, nbits_big).astype(np.int32)
    bits = np.where(small, 0, bits_big).astype(np.uint32)
    return token, nbits, bits


def uint_decode_token(token: int, reader) -> int:
    """Single-value inverse (used by the verification decoder)."""
    if token < 16:
        return token
    n = token >> 2
    nbits = n - 2
    bits = reader.read(nbits)
    return (1 << n) | ((token & 3) << nbits) | bits
