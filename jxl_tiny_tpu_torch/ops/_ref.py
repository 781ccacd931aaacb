"""Numpy helpers the port keeps its own copies of (from the JAX package's
numpy golden model: ref/pipeline_np._strided_sum, ref/group_np._threshold_map,
ref/dct_np.dct_matrix and dct16_half_mats)."""
import functools

import numpy as np


def strided_sum(a, n, axis):
    """Sum n-strided slices along axis, sequential left-fold order.

    The fold order is pinned so float results stay bit-equal across
    implementations (the plain torch versions and the CUDA kernels use the
    same order); implicit reduction orders are backend-defined. Works on
    numpy arrays and torch tensors alike."""
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, None, n)
    s = a[tuple(sl)]
    for i in range(1, n):
        sl[axis] = slice(i, None, n)
        s = s + a[tuple(sl)]
    return s


def _quantize_block_thresholds(c, cx, cy):
    """Zero-bias thresholds per coefficient quadrant (enc_group.cc:227-241).

    Returns thres[4]: indexed by yfix*2 + xfix where yfix/xfix select the
    high-frequency half along each axis of the stored coefficient block.
    """
    thres = np.array([0.58, 0.635, 0.66, 0.7], np.float32)
    if c == 0:
        thres[1:] += 0.08
    if c == 2:
        thres[1:] = 0.75
    if cx > 1 or cy > 1:
        thres -= np.clip(0.003 * cx * cy, 0.0, 0.08 if c > 0 else 0.12)
    return thres.astype(np.float32)


def threshold_map(c, cx, cy):
    """Full per-coefficient threshold array in stored layout [cy*8, cx*8]."""
    thres = _quantize_block_thresholds(c, max(cx, cy), min(cx, cy))
    rows, cols = min(cy, cx) * 8, max(cy, cx) * 8
    t = np.zeros((rows, cols), np.float32)
    yfix = (np.arange(rows) >= rows // 2).astype(np.int32) * 2
    xfix = (np.arange(cols) >= cols // 2).astype(np.int32)
    t[:] = thres[yfix[:, None] + xfix[None, :]]
    return t


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Forward scaled-DCT matrix D: C = D @ x (enc_transforms-inl.h
    convention: C[k] = (1/N) a_k sum_i x[i] cos(pi k (2i+1) / 2N),
    a_0 = 1, a_k = sqrt(2))."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) / n
    d[1:] *= np.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct16_half_mats():
    """Recombination matrices (A0, A1), each [16, 8] f32: the 16-point
    scaled DCT of two stacked halves as a fixed linear map of the halves'
    8-point DCTs,

      C16[k] = sum_i A0[k, i] * C8_first[i] + A1[k, i] * C8_second[i]
      A0 = D16[:, :8] @ IDCT8,  A1 = D16[:, 8:] @ IDCT8

    built in float64 and rounded once to float32."""
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
