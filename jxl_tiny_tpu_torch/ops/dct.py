"""Scaled DCT of 8x8 blocks as float32 matrix products.

Counterpart of the JAX package's ops/dct_jax.dct2d (8x8 only: the 16x8 and
8x16 recombinations belong to the AC-strategy search, not ported yet). The
JAX package runs these contractions at Precision.HIGHEST; here TF32 is
switched off for CUDA matmuls and cuDNN before the product, so the card
computes them in full float32. Eager PyTorch does not fuse across ops, so
the JAX package's optimization barriers have no counterpart.
"""
import torch


def dct2d_8x8(blocks, dct8):
    """blocks: [..., 8(y), 8(x)] f32 pixels; dct8: [8, 8] f32 DCT matrix.

    Returns [..., 8(xfreq), 8(yfreq)] coefficients (the reference's 8x8
    layout, ref/dct_np.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # coef[.., l, k] = sum_{y,x} D[k, y] P[y, x] D[l, x]
    return torch.einsum("ky,...yx,lx->...lk", dct8, blocks, dct8)
