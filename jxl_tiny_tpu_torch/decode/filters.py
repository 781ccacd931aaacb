"""Restoration filters (gaborish + edge-preserving filter) for the
verification decoder — modeling what stock djxl renders.

The tiny encoder signals (WriteFrameHeader, enc_frame.cc:426-457):
  - d <  0.7 : epf_iters=0, gaborish off  -> no filters
  - d <  1.5 : epf_iters=1, gaborish off
  - d <  4.0 : the all-default loop filter -> gaborish ON + epf_iters=2
  - d >= 4.0 : epf_iters=3, gaborish off

All constants below are the JPEG XL loop-filter *defaults* (ISO/IEC
18181-1; public libjxl LoopFilter/epf defaults), since the tiny encoder
always signals default sharpness/weights/sigma. These filters model stock
djxl's rendering, so that the signaled filter chain is exercised end to
end; a copy of the JAX package's decode/filters.py.

Filters operate on the XYB image (before the color transform), mirrored at
image borders, full-precision numpy.
"""
import numpy as np

# Gaborish 3x3 kernel weights (spec defaults: 1, w1, w2 normalized).
_GAB_W1 = np.float32(0.115169525)
_GAB_W2 = np.float32(0.061248592)

# EPF defaults.
_EPF_QUANT_MUL = 0.46  # lf.epf_quant_mul
_EPF_PASS0_SIGMA_SCALE = 0.9
_EPF_PASS2_SIGMA_SCALE = 6.5
_EPF_BORDER_SAD_MUL = 2.0 / 3.0  # pixels on 8x8 block borders
_EPF_CHANNEL_SCALE = np.array([40.0, 5.0, 3.5], np.float32)  # X, Y, B
# VarDCT frames fill the per-block sharpness plane with 4; the default
# sharpness lut maps k -> k/7.
_EPF_SHARPNESS = 4.0 / 7.0
_INV_SIGMA_NUM = 4.0 * (np.sqrt(0.5) - 1.0)  # -1.1715728752538097
_MIN_SIGMA = 0.3  # blocks quantized finer than this skip the EPF


def _mirror_pad(img, n):
    return np.pad(img, ((0, 0), (n, n), (n, n)), mode="reflect")


def gaborish(xyb):
    """3x3 smoothing convolution, per channel ('gab' stage)."""
    w0 = np.float32(1.0)
    norm = np.float32(1.0) / (w0 + 4 * _GAB_W1 + 4 * _GAB_W2)
    p = _mirror_pad(xyb.astype(np.float32), 1)
    c = p[:, 1:-1, 1:-1]
    edges = (
        p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
    )
    diags = p[:, :-2, :-2] + p[:, :-2, 2:] + p[:, 2:, :-2] + p[:, 2:, 2:]
    return ((w0 * c + _GAB_W1 * edges + _GAB_W2 * diags) * norm).astype(
        np.float32
    )


def _sigma_map(raw_qf, scale):
    """Per-block EPF sigma from the adaptive quant field (the decoder-side
    twin of the encoder's raw_quant_field; inv_quant = 1 / (scale * qf))."""
    inv_quant = 1.0 / (np.float32(scale) * raw_qf.astype(np.float32))
    return inv_quant * np.float32(_EPF_QUANT_MUL * _EPF_SHARPNESS)


def _pixel_maps(sigma_blocks, h, w):
    """Upsample per-block sigma to pixels; border-pixel SAD multiplier."""
    sig = np.repeat(np.repeat(sigma_blocks, 8, 0), 8, 1)[:h, :w]
    yy = np.arange(h) % 8
    xx = np.arange(w) % 8
    border = ((yy == 0) | (yy == 7))[:, None] | ((xx == 0) | (xx == 7))[None, :]
    sad_mul = np.where(border, np.float32(_EPF_BORDER_SAD_MUL), np.float32(1.0))
    return sig.astype(np.float32), sad_mul.astype(np.float32)


def _epf_step(xyb, sig, sad_mul, offsets, sigma_scale, patch):
    """One EPF iteration: weighted average over `offsets` neighbours.

    patch=True: SADs over plus-shaped 5-pixel patches (passes 0 and 1);
    patch=False: direct pixel differences (pass 2). Weight for neighbour n
    is max(0, 1 + SAD(n) * inv_sigma); the centre always has weight 1."""
    h, w = xyb.shape[1:]
    pad = 3  # offsets up to 2 + patch radius 1
    p = _mirror_pad(xyb, pad)

    if patch:
        # Per-pixel cross-patch "feature" rows: SAD between shifted copies
        # of this combined map equals the patch SAD between pixels.
        plus = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    else:
        plus = [(0, 0)]

    def shifted(dy, dx):
        return p[:, pad + dy : pad + dy + h, pad + dx : pad + dx + w]

    inv_sigma = np.where(
        sig >= _MIN_SIGMA,
        np.float32(_INV_SIGMA_NUM) / (sig * np.float32(sigma_scale)),
        np.float32(0.0),
    )
    skip = sig < _MIN_SIGMA
    wsum = np.ones((h, w), np.float32)
    acc = xyb.copy()
    for dy, dx in offsets:
        if dy == 0 and dx == 0:
            continue
        sad = np.zeros((h, w), np.float32)
        for c in range(3):
            s = np.zeros((h, w), np.float32)
            for py, px in plus:
                s += np.abs(
                    shifted(py, px)[c] - shifted(dy + py, dx + px)[c]
                )
            sad += s * _EPF_CHANNEL_SCALE[c]
        wgt = np.maximum(
            np.float32(0.0), np.float32(1.0) + sad * sad_mul * inv_sigma
        )
        wsum += wgt
        acc += shifted(dy, dx) * wgt[None]
    out = acc / wsum[None]
    return np.where(skip[None], xyb, out).astype(np.float32)


_OFFS_CROSS = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
_OFFS_WIDE = _OFFS_CROSS + [
    (-2, 0), (2, 0), (0, -2), (0, 2), (-1, -1), (-1, 1), (1, -1), (1, 1),
]


def epf(xyb, raw_qf, scale, iters):
    """Edge-preserving filter, `iters` in 1..3 (spec pass structure:
    iters==3 adds the wide pass 0 first; iters>=2 appends the direct-diff
    pass 2)."""
    h, w = xyb.shape[1:]
    sig, sad_mul = _pixel_maps(_sigma_map(raw_qf, scale), h, w)
    out = xyb.astype(np.float32)
    if iters >= 3:
        out = _epf_step(
            out, sig, sad_mul, _OFFS_WIDE, _EPF_PASS0_SIGMA_SCALE, True
        )
    if iters >= 1:
        out = _epf_step(out, sig, sad_mul, _OFFS_CROSS, 1.0, True)
    if iters >= 2:
        out = _epf_step(
            out, sig, sad_mul, _OFFS_CROSS, _EPF_PASS2_SIGMA_SCALE, False
        )
    return out


def apply_restoration_filters(xyb, raw_qf, scale, epf_iters, gab):
    """The signaled filter chain, in render order: gaborish then EPF."""
    out = xyb.astype(np.float32)
    if gab:
        out = gaborish(out)
    if epf_iters > 0:
        out = epf(out, raw_qf, scale, epf_iters)
    return out
