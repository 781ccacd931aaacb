"""Scaled DCT of 8x8 blocks as float32 matrix products, and the 16x8 / 8x16
transforms recombined from pairs of 8x8 DCTs.

Counterpart of the JAX package's ops/dct_jax (dct2d for 8x8 blocks,
dct16x8_from_8, dct8x16_from_8). The JAX package runs these contractions
at Precision.HIGHEST; here TF32 is switched off for CUDA matmuls and cuDNN
before the product, so the card computes them in full float32. Eager
PyTorch does not fuse across ops, so the JAX package's optimization
barriers have no counterpart: each contraction below is a standalone
product already.
"""
import torch


def _full_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dct2d_8x8(blocks, dct8):
    """blocks: [..., 8(y), 8(x)] f32 pixels; dct8: [8, 8] f32 DCT matrix.

    Returns [..., 8(xfreq), 8(yfreq)] coefficients (the reference's 8x8
    layout, ref/dct_np.py)."""
    _full_float32()
    # coef[.., l, k] = sum_{y,x} D[k, y] P[y, x] D[l, x]
    return torch.einsum("ky,...yx,lx->...lk", dct8, blocks, dct8)


def dct16x8_from_8(c_top, c_bot, a0, a1):
    """DCT16X8 (16 rows x 8 columns of pixels) coefficients from the two
    stacked 8x8 DCT blocks. c_top/c_bot: [..., 8(xfreq), 8(yfreq)]; a0/a1:
    the [16, 8] half matrices (tables.dct16_a0 / dct16_a1).

    Returns [..., 8(xfreq), 16(yfreq)]: two K=8 contractions, each a
    product of its own, then one add."""
    _full_float32()
    top = torch.einsum("...li,ki->...lk", c_top, a0)
    bot = torch.einsum("...li,ki->...lk", c_bot, a1)
    return top + bot


def dct8x16_from_8(c_left, c_right, a0, a1):
    """DCT8X16 (8 rows x 16 columns of pixels) coefficients from the two
    side-by-side 8x8 DCT blocks. c_left/c_right: [..., 8(xfreq), 8(yfreq)].

    Returns [..., 8(yfreq), 16(xfreq)]."""
    _full_float32()
    left = torch.einsum("...jk,lj->...kl", c_left, a0)
    right = torch.einsum("...jk,lj->...kl", c_right, a1)
    return left + right
