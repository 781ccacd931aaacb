"""Scaled DCT-II used by JPEG XL, as dense matrix products (numpy golden model).

Convention (matches the reference's recursive implementation,
encoder/enc_transforms-inl.h:289-546, verified by round-trip against its
ComputeScaledDCT):

  C[k] = (1/N) * a_k * sum_i x[i] * cos(pi*k*(2i+1)/(2N)),  a_0=1, a_k=sqrt(2)
  x[i] = sum_k a_k * C[k] * cos(pi*k*(2i+1)/(2N))

2-D coefficient storage layout (enc_transforms-inl.h:527-546):
  - DCT8   (8x8 px):   out[xfreq, yfreq]           (8x8)
  - DCT16X8 (8w x 16h): out[xfreq, yfreq]           (8x16, LLF at [0,0],[0,1])
  - DCT8X16 (16w x 8h): out[yfreq, xfreq]           (8x16, LLF at [0,0],[0,1])
i.e. always [short-axis freq, long-axis freq] with the DC/LLF first in raster.

Frozen copy for the benchmark of jxl_tiny_tpu_torch/ref/dct_np.py at commit
8ebce9c.
"""
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Forward scaled-DCT matrix D: C = D @ x."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) / n
    d[1:] *= np.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def idct_matrix(n: int) -> np.ndarray:
    """Inverse: x = IDCT @ C, IDCT = (n * D)^T."""
    return (dct_matrix(n).T * n).astype(np.float32)


def dct2d_blocks(pixels: np.ndarray) -> np.ndarray:
    """Batched 2-D scaled DCT with reference layout.

    pixels: [..., R, C] -> coefficients [..., min(R,C), max(R,C)].
    """
    r, c = pixels.shape[-2], pixels.shape[-1]
    dr = dct_matrix(r)
    dc = dct_matrix(c)
    # [yfreq, xfreq] = Dr @ P @ Dc^T
    coef = np.einsum("ky,...yx,lx->...kl", dr, pixels, dc, optimize=True)
    if r >= c:
        # layout [xfreq, yfreq]
        coef = np.swapaxes(coef, -2, -1)
    return np.ascontiguousarray(coef)


@functools.lru_cache(maxsize=None)
def dct16_half_mats():
    """Recombination matrices (A0, A1), each [16, 8] f32.

    A 16-point scaled DCT of stacked halves is a fixed linear map of the
    two 8-point DCTs of the halves (the reference recombines DCT sizes the
    same way through DCTResampleScales, dct_scales.h:42-74):

      C16[k] = sum_i A0[k, i] * C8_top[i] + A1[k, i] * C8_bot[i]
      A0 = D16[:, :8] @ IDCT8,  A1 = D16[:, 8:] @ IDCT8

    Built in float64 and rounded once to f32, so the per-coefficient error
    of the f32 recombination is ~1 ulp relative to a direct DCT16."""
    k = np.arange(16)[:, None].astype(np.float64)
    i = np.arange(16)[None, :].astype(np.float64)
    d16 = np.cos(np.pi * k * (2 * i + 1) / 32.0) / 16.0
    d16[1:] *= np.sqrt(2.0)
    kk = np.arange(8)[:, None].astype(np.float64)
    ii = np.arange(8)[None, :].astype(np.float64)
    d8 = np.cos(np.pi * kk * (2 * ii + 1) / 16.0) / 8.0
    d8[1:] *= np.sqrt(2.0)
    i8 = d8.T * 8.0  # IDCT8 (f64)
    return (
        (d16[:, :8] @ i8).astype(np.float32),
        (d16[:, 8:] @ i8).astype(np.float32),
    )


def dct16x8_from_8(c_top: np.ndarray, c_bot: np.ndarray) -> np.ndarray:
    """DCT16X8 (16 rows x 8 cols of pixels) coefficients from the two
    stacked 8x8 DCT blocks. c_top/c_bot: [..., 8(xfreq), 8(yfreq)]
    (dct2d_blocks 8x8 layout) -> [..., 8(xfreq), 16(yfreq)] (the
    dct2d_blocks 16x8 layout). Two K=8 contractions + one add, the same
    accumulation class as dct2d_blocks itself (ops/dct.py's torch form
    contracts the same halves with tables.dct16_a0 / dct16_a1)."""
    a0, a1 = dct16_half_mats()
    return np.einsum("...li,ki->...lk", c_top, a0, optimize=True) + np.einsum(
        "...li,ki->...lk", c_bot, a1, optimize=True
    )


def dct8x16_from_8(c_left: np.ndarray, c_right: np.ndarray) -> np.ndarray:
    """DCT8X16 (8 rows x 16 cols of pixels) coefficients from the two
    side-by-side 8x8 DCT blocks. c_left/c_right: [..., 8(xfreq), 8(yfreq)]
    -> [..., 8(yfreq), 16(xfreq)] (the dct2d_blocks 8x16 layout)."""
    a0, a1 = dct16_half_mats()
    return np.einsum("...jk,lj->...kl", c_left, a0, optimize=True) + np.einsum(
        "...jk,lj->...kl", c_right, a1, optimize=True
    )


_IDCT_PATHS = {}


def idct2d_blocks(coef: np.ndarray, r: int, c: int) -> np.ndarray:
    """Inverse of dct2d_blocks: coefficients [..., min, max] -> pixels [..., R, C].

    The contraction path np.einsum(optimize=True) would choose is found
    once a shape and reused (the verification decoder calls this once a
    block): the same contractions in the same order, without the search."""
    if r >= c:
        coef = np.swapaxes(coef, -2, -1)
    ir = idct_matrix(r)
    ic = idct_matrix(c)
    key = (coef.shape, coef.dtype.str, r, c)
    if key not in _IDCT_PATHS:
        _IDCT_PATHS[key] = np.einsum_path("yk,...kl,xl->...yx", ir, coef, ic,
                                          optimize=True)[0]
    return np.einsum("yk,...kl,xl->...yx", ir, coef, ic, optimize=_IDCT_PATHS[key])
