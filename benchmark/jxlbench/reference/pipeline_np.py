"""Numpy golden model of the per-group analysis + encode pipeline.

This is the specification implementation that the device pipeline (torch
ops and the CUDA kernels' plain versions, ops/) is tested against; a copy
of the JAX package's ref/pipeline_np.py, float32 semantics included. It
processes one 256x256 group at a time, fully vectorized over blocks. Behavior mirrors the reference encoder stage by stage (citations
inline), with one deliberate difference: heuristics operate on whole groups
with group-edge clamping instead of the reference's 256x64 stripes
(enc_frame.cc:729-756) — stripes are a CPU working-set optimization, not a data
dependency; outputs differ only in a handful of AQ-field pixels at internal
stripe boundaries.

Frozen copy for the benchmark of jxl_tiny_tpu_torch/ref/pipeline_np.py at
commit 8ebce9c.
"""

import numpy as np

from . import constants as C
from .dct_np import dct2d_blocks, dct16x8_from_8, dct8x16_from_8


# ---------------------------------------------------------------------------
# Color transform (reference: enc_xyb.cc:44-81)
# ---------------------------------------------------------------------------


def to_xyb(rgb: np.ndarray) -> np.ndarray:
    """rgb: [3, H, W] linear sRGB -> XYB in place order [X, Y, B]."""
    rgb = rgb.astype(np.float32)
    mixed = np.einsum("ij,jhw->ihw", C.OPSIN_MATRIX, rgb) + C.OPSIN_BIAS
    mixed = np.maximum(mixed, 0.0)
    tm = np.cbrt(mixed) + C.NEG_BIAS_CBRT
    x = 0.5 * (tm[0] - tm[1])
    y = 0.5 * (tm[0] + tm[1])
    b = tm[2]
    return np.stack([x, y, b]).astype(np.float32)


# ---------------------------------------------------------------------------
# Adaptive quantization field (reference: enc_adaptive_quantization.cc)
# ---------------------------------------------------------------------------

_K_SG_MUL = 226.0480446705883
_K_SG_MUL2 = 1.0 / 73.377132366608819
_K_LOG2 = 0.693147181
_K_SG_RET_MUL = _K_SG_MUL2 * 18.6580932135 * _K_LOG2
_K_SG_V_OFFSET = 7.14672470003


def _ratio_of_derivatives(v, invert):
    """enc_adaptive_quantization.cc:85-104."""
    eps = np.float32(1e-2)
    v = np.maximum(v, 0.0).astype(np.float32)
    num_mul = np.float32(_K_SG_RET_MUL * 3 * _K_SG_MUL)
    v_offset = np.float32(_K_SG_V_OFFSET * _K_LOG2 + 1e-2)
    den_mul = np.float32(_K_LOG2 * _K_SG_MUL)
    v2 = v * v
    num = num_mul * v2 + eps
    den = den_mul * v * v2 + v_offset
    return num / den if invert else den / num


def _masking_sqrt(v):
    """enc_adaptive_quantization.cc:287-294."""
    k_log_offset = np.float32(26.481471032459346)
    k_mul = np.float32(211.50759899638012 * 1e8)
    return np.float32(0.25) * np.sqrt(v * np.sqrt(k_mul) + k_log_offset)


def _clamped_shift(a, dy, dx):
    """Shift a 2-D array by (dy, dx) with edge clamping."""
    h, w = a.shape[-2:]
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    return a[..., ys[:, None], xs[None, :]]


def _compute_mask(v):
    """enc_adaptive_quantization.cc:52-75."""
    v1 = np.maximum(v * np.float32(0.74760422233706747), np.float32(1e-3))
    v2 = 1.0 / (v1 + np.float32(305.04035728311436))
    v3 = 1.0 / (v1 * v1 + np.float32(2.1925739705298404))
    v4 = 1.0 / (v1 * v1 + np.float32(0.25 * 2.1925739705298404))
    return (
        np.float32(-0.74174993)
        + np.float32(3.2353257320940401) * v4
        + np.float32(12.906028311180409) * v2
        + np.float32(5.0220313103171232) * v3
    )


def strided_sum(a, n, axis):
    """Sum n-strided slices along axis, sequential left-fold order.

    The fold order is pinned (identical expressions in the numpy golden,
    the plain torch versions and the CUDA kernels) so float results stay
    bit-equal across implementations; implicit reshape-sum reduction
    orders are backend-defined. Works on numpy arrays and torch tensors
    alike."""
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, None, n)
    s = a[tuple(sl)]
    for i in range(1, n):
        sl[axis] = slice(i, None, n)
        s = s + a[tuple(sl)]
    return s


def _block_sums(a):
    """Sum over 8x8 blocks: [H, W] -> [H/8, W/8]."""
    return strided_sum(strided_sum(a, 8, 1), 8, 0)


def compute_adaptive_quant_field(xyb: np.ndarray, distance: float, inv_scale: float):
    """xyb: [3, H, W] (H, W multiples of 8) of one group.

    Returns (qf float [H/8, W/8], masking [H/8, W/8], raw_quant_field u8).
    """
    _, h, w = xyb.shape
    scale = np.float32(0.8294) / np.float32(distance)
    match_gamma_offset = np.float32(0.019)
    k_x_mul = np.float32(23.426802998210313)

    # Local difference map (":409-492"), 4x subsampled.
    y_pl = xyb[1]
    x_pl = xyb[0]
    gammac = _ratio_of_derivatives(y_pl + match_gamma_offset, invert=False)
    base_y = 0.25 * (
        _clamped_shift(y_pl, 1, 0)
        + _clamped_shift(y_pl, -1, 0)
        + _clamped_shift(y_pl, 0, -1)
        + _clamped_shift(y_pl, 0, 1)
    )
    diff_y = gammac * (y_pl - base_y)
    diff_y = diff_y * diff_y
    base_x = 0.25 * (
        _clamped_shift(x_pl, 1, 0)
        + _clamped_shift(x_pl, -1, 0)
        + _clamped_shift(x_pl, 0, -1)
        + _clamped_shift(x_pl, 0, 1)
    )
    diff_x = gammac * (x_pl - base_x)
    diff_x = diff_x * diff_x
    diff = _masking_sqrt(diff_y + k_x_mul * diff_x).astype(np.float32)
    # 4x4 subsample: sum * 0.25 (":484-491").
    pre_erosion = (
        strided_sum(strided_sum(diff, 4, 1), 4, 0) * np.float32(0.25)
    ).astype(np.float32)

    # Fuzzy erosion (":326-374"): 0.05*(center + 4 smallest of 3x3), 2x down.
    neigh = np.stack(
        [
            _clamped_shift(pre_erosion, dy, dx)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ]
    )
    neigh_sorted = np.sort(neigh, axis=0)
    low4 = (neigh_sorted[0] + neigh_sorted[1]) + (
        neigh_sorted[2] + neigh_sorted[3]
    )
    v = np.float32(0.05) * (pre_erosion + low4)
    aq = strided_sum(strided_sum(v, 2, 1), 2, 0).astype(np.float32)

    masking = (1.0 / (aq + np.float32(0.001))).astype(np.float32)

    # Per-block modulations (":249-284").
    val = _compute_mask(aq)

    # HfModulation (":210-247"): sum of |right diff| (cols 0..6) + |down diff|
    # (rows 0..6) within each 8x8 block of the Y plane.
    right = np.abs(y_pl[:, 1:] - y_pl[:, :-1])
    right = np.concatenate([right, np.zeros((h, 1), np.float32)], axis=1)
    right[:, 7::8] = 0.0  # no cross-block diffs
    down = np.abs(y_pl[1:, :] - y_pl[:-1, :])
    down = np.concatenate([down, np.zeros((1, w), np.float32)], axis=0)
    down[7::8, :] = 0.0
    hf_sum = _block_sums(right + down)
    val = val + hf_sum * np.float32(-2.0052193233688884 / 112)

    # ColorModulation (":146-207").
    strength = np.float32(2.177823400325309) * np.float32(1.0 - 0.25 * distance)
    if strength >= 0:
        red_strength = strength * np.float32(5.992297772961519)
        blue_strength = strength
        offset = strength * np.float32(-0.009174542291185913)
        k_red_start = np.float32(0.0073200141118951231)
        k_red_len = np.float32(0.019421555948474039)
        k_blue_start = np.float32(0.26973418507870539)
        k_blue_len = np.float32(0.086890611400405895)
        red_slope = np.minimum(np.maximum(xyb[0] - k_red_start, 0.0), k_red_len)
        blue_slope = np.minimum(
            np.maximum(xyb[2] - (xyb[1] + k_blue_start), 0.0), k_blue_len
        )
        ratio = np.float32(30.610615782142737)
        red_cov = np.minimum(_block_sums(red_slope), ratio * k_red_len)
        blue_cov = np.minimum(_block_sums(blue_slope), ratio * k_blue_len)
        val = (
            val
            + offset
            + red_cov * (red_strength / ratio)
            + blue_cov * (blue_strength / ratio)
        )

    # GammaModulation (":114-144").
    bias = np.float32(0.16)
    r = (xyb[1] + bias) - xyb[0]
    g = (xyb[1] + bias) + xyb[0]
    ratio_avg = 0.5 * (
        _ratio_of_derivatives(r, invert=True) + _ratio_of_derivatives(g, invert=True)
    )
    overall = _block_sums(ratio_avg) * np.float32(1.0 / 64)
    k_gam = np.float32(-0.15526878023684174 * 0.693147180559945)
    val = val + k_gam * np.log2(overall)

    # exponent -> multiplicative field (":280-283"); dampen==1 for d < 7.
    dampen = np.float32(1.0)
    if distance >= 7.0:
        dampen = np.float32(max(0.0, 1.0 - (distance - 7.0) / 7.0))
    mul = scale * dampen
    add = (np.float32(1.0) - dampen) * np.float32(0.5) * scale
    qf = (np.exp2(val * np.float32(1.442695041)) * mul + add).astype(np.float32)

    raw_qf = np.clip(
        (qf * np.float32(inv_scale) + np.float32(0.5)).astype(np.int32), 1, 255
    ).astype(np.uint8)
    return qf, masking, raw_qf


def compute_adaptive_quant_field_striped(xyb, distance, inv_scale):
    """Stripe-faithful AQ variant: the reference computes the field one
    256x64 stripe at a time (enc_frame.cc:729-756) with neighborhood
    clamping at the stripe buffer's rows 0/63
    (enc_adaptive_quantization.cc:396-410 — the +-1 local-diff and the +-4
    extension clamp at `ysize` of the 64-row stripe image; horizontally the
    stripe spans the whole group, so column clamping is identical to the
    whole-group computation). Production pipelines deliberately clamp at
    group edges instead; this variant exists to *measure* that deviation
    (tests/test_stripe_deviation.py)."""
    parts = [
        compute_adaptive_quant_field(xyb[:, y : y + 64, :], distance, inv_scale)
        for y in range(0, xyb.shape[1], 64)
    ]
    return tuple(np.concatenate([p[k] for p in parts], axis=0) for k in range(3))


# ---------------------------------------------------------------------------
# Chroma from luma (reference: enc_chroma_from_luma.cc)
# ---------------------------------------------------------------------------


def compute_cmap(xyb: np.ndarray, xsize_blocks=None, ysize_blocks=None):
    """Per 64x64 tile CfL factors. xyb: [3, H, W] -> (ytox, ytob) int8 [ty, tx].

    Only blocks inside (ysize_blocks, xsize_blocks) contribute (the reference
    iterates the clipped tile rect, enc_chroma_from_luma.cc:87-125).
    """
    _, h, w = xyb.shape
    yb, xb = h // 8, w // 8
    if xsize_blocks is None:
        xsize_blocks = xb
    if ysize_blocks is None:
        ysize_blocks = yb
    coef = dct2d_blocks(
        xyb.reshape(3, yb, 8, xb, 8).transpose(0, 1, 3, 2, 4)
    )  # [3, yb, xb, 8, 8]
    qm_x = C.QUANT_DCT8[0]
    qm_b = C.QUANT_DCT8[2]
    m_x = coef[1] * qm_x  # y weighted for x fit (DC weight already 0)
    s_x = coef[0] * qm_x
    m_b = coef[1] * qm_b
    s_b = coef[2] * qm_b

    ty, tx = -(-ysize_blocks // 8), -(-xsize_blocks // 8)
    ytox = np.zeros((ty, tx), np.int8)
    ytob = np.zeros((ty, tx), np.int8)
    for t_y in range(ty):
        for t_x in range(tx):
            by0, by1 = t_y * 8, min((t_y + 1) * 8, ysize_blocks)
            bx0, bx1 = t_x * 8, min((t_x + 1) * 8, xsize_blocks)
            n = (by1 - by0) * (bx1 - bx0) * 64
            ytox[t_y, t_x] = _find_best_multiplier(
                m_x[by0:by1, bx0:bx1], s_x[by0:by1, bx0:bx1], n, 0.0
            )
            ytob[t_y, t_x] = _find_best_multiplier(
                m_b[by0:by1, bx0:bx1], s_b[by0:by1, bx0:bx1], n, 1.0
            )
    return ytox, ytob


def _find_best_multiplier(m, s, num, base):
    """enc_chroma_from_luma.cc:40-62 (distance_mul = 1e-3)."""
    a = (C.INV_COLOR_FACTOR * m).astype(np.float32)
    b = (np.float32(base) * m - s).astype(np.float32)
    ca = float((a * a).sum(dtype=np.float32))
    cb = float((a * b).sum(dtype=np.float32))
    x = -cb / (ca + num * 1e-3 * 0.5)
    return int(np.clip(_round_away(x), -128, 127))


def _round_away(x):
    """C roundf: round half away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


# ---------------------------------------------------------------------------
# AC strategy selection (reference: enc_ac_strategy.cc)
# ---------------------------------------------------------------------------


def _estimate_entropy_batch(coef, qm, q, masking, cmap_fac, coef_y, distance):
    """Vectorized EstimateEntropy core (enc_ac_strategy.cc:51-146).

    coef:  [3, N, S] candidate coefficients (S = 64 or 128)
    qm:    [3, S] inverse dequant (LLF zeroed)
    q:     [N] quant field max over covered blocks
    masking: [N]
    cmap_fac: [3, N] (X/B rows hold the CfL factors; Y row zero)
    coef_y: [N, S] the Y coefficients (for CfL subtraction)
    Returns entropy estimate [N].
    """
    num_blocks = coef.shape[-1] // 64
    val = (coef - cmap_fac[..., None] * coef_y[None]) * qm[:, None, :] * q[None, :, None]
    rval = np.rint(val)  # ties to even, like hwy Round
    diff = np.abs(val - rval)
    info_loss = diff.sum(axis=(0, 2))
    info_loss2 = (diff * diff).sum(axis=(0, 2))
    aq = np.abs(rval)
    nzeros = (aq != 0).sum(axis=2)  # [3, N]

    slope = min(1.0, distance / 3.0)
    cost1 = np.float32(1.0 + slope * 8.8703248061477744)
    cost2 = np.float32(4.4628149885273363)
    cost_delta = np.float32(5.3359184934516337)
    ent = (
        (aq >= 1.5).sum(axis=2) * cost2
        + np.sqrt(aq).sum(axis=2, dtype=np.float32) * cost_delta
        + nzeros * cost1
    )  # [3, N]
    # #bits of nzeros cost (":133-139").
    nbits = _ceil_log2_nonzero(nzeros + 1) + 1
    k_zeros_mul = np.float32(7.565053364251793)
    ent = ent + k_zeros_mul * (_ceil_log2_nonzero(nbits + 17) + nbits)
    entropy = ent.sum(axis=0)
    info_loss_score = np.float32(138.0) * info_loss + np.float32(
        50.46839691767866
    ) * np.sqrt(num_blocks * info_loss2)
    return entropy + masking * info_loss_score


def _ceil_log2_nonzero(v):
    """CeilLog2Nonzero for positive ints, elementwise."""
    v = np.asarray(v)
    return np.ceil(np.log2(np.maximum(v, 1))).astype(np.int32) + (
        0 * v
    )  # exact for ints up to 2**24 in float64


def compute_ac_strategy(
    xyb, qf, masking, ytox, ytob, distance, xsize_blocks, ysize_blocks
):
    """Returns strategy raw type [yb, xb] u8 and is_first [yb, xb] bool.

    xyb: [3, H, W] group (padded); qf/masking: [H/8, W/8] float;
    ytox/ytob: per-tile int8. Only blocks inside (ysize_blocks, xsize_blocks)
    are decided; padded cells keep DCT8.
    """
    _, h, w = xyb.shape
    yb, xb = h // 8, w // 8
    strategy = np.zeros((yb, xb), np.uint8)
    is_first = np.ones((yb, xb), bool)

    # Candidate coefficient sets. The DCT16 families come from
    # recombination of the 8x8 DCTs (dct_np.dct16x8_from_8) rather than
    # fresh 16-point transforms — bit-equal to the device pipeline's form.
    blocks8 = xyb.reshape(3, yb, 8, xb, 8).transpose(0, 1, 3, 2, 4)
    coef8b = dct2d_blocks(blocks8)  # [3, yb, xb, 8, 8]
    coef8 = coef8b.reshape(3, yb, xb, 64)
    # Vertical 16x8 (8w x 16h) at even by.
    coef_v = dct16x8_from_8(coef8b[:, 0::2], coef8b[:, 1::2]).reshape(
        3, yb // 2, xb, 128
    )
    # Horizontal 8x16 (16w x 8h) at even bx.
    coef_h = dct8x16_from_8(coef8b[:, :, 0::2], coef8b[:, :, 1::2]).reshape(
        3, yb, xb // 2, 128
    )

    qm8 = C.QUANT_DCT8.reshape(3, 64)
    qm16 = C.QUANT_DCT16.reshape(3, 128)

    # Per-tile cmap factors expanded per block.
    fac_x = (ytox.astype(np.float32) * C.INV_COLOR_FACTOR).repeat(8, 0).repeat(8, 1)
    fac_b = (1.0 + ytob.astype(np.float32) * C.INV_COLOR_FACTOR).repeat(8, 0).repeat(
        8, 1
    )
    fac_x = fac_x[:yb, :xb]
    fac_b = fac_b[:yb, :xb]

    mul8 = np.float32(
        1.0735757687292623 * 0.75 + (-0.55 * 0.75) / (distance + 1.4)
    )
    mul16 = np.float32(0.9019587899705066 + (-0.55) / (distance + 1.6))

    def entropy8(by, bx):
        # [len(by)] entropies for 8x8 at block coords arrays
        sel = (slice(None), by, bx)
        coef = coef8[sel]
        cf = np.stack([fac_x[by, bx], np.zeros(len(by), np.float32), fac_b[by, bx]])
        return _estimate_entropy_batch(
            coef, qm8, qf[by, bx], masking[by, bx], cf, coef8[1][by, bx], distance
        )

    # Quad grid (16x16 quads); only full quads within valid area are searched
    # and only within one 64x64 tile (tile loop in enc_frame.cc:669-677 is
    # bounded by the tile rect, so quads never straddle tiles; tiles are
    # 8-block aligned so this only matters at the image edge).
    qys, qxs = [], []
    for qy in range(0, yb - 1, 2):
        for qx in range(0, xb - 1, 2):
            if qy + 2 <= ysize_blocks and qx + 2 <= xsize_blocks:
                qys.append(qy)
                qxs.append(qx)
    if not qys:
        return strategy, is_first
    qys = np.array(qys)
    qxs = np.array(qxs)
    n = len(qys)

    # 4 entropies of 8x8 sub-blocks.
    e8 = np.zeros((2, 2, n), np.float32)
    for dy in range(2):
        for dx in range(2):
            e8[dy, dx] = np.float32(3.0) * mul8 + mul8 * entropy8(qys + dy, qxs + dx)

    # quant/masking max over the two covered blocks for multi-block candidates.
    def maxq(by, bx, dy2, dx2):
        return np.maximum(qf[by, bx], qf[by + dy2, bx + dx2]), np.maximum(
            masking[by, bx], masking[by + dy2, bx + dx2]
        )

    def entropy_v(by, bx):  # vertical 16x8 whose top block is (by, bx)
        coef = coef_v[:, by // 2, bx]
        q, m = maxq(by, bx, 1, 0)
        cf = np.stack([fac_x[by, bx], np.zeros(n, np.float32), fac_b[by, bx]])
        return _estimate_entropy_batch(
            coef, qm16, q, m, cf, coef_v[1][by // 2, bx], distance
        )

    def entropy_h(by, bx):  # horizontal 8x16 whose left block is (by, bx)
        coef = coef_h[:, by, bx // 2]
        q, m = maxq(by, bx, 0, 1)
        cf = np.stack([fac_x[by, bx], np.zeros(n, np.float32), fac_b[by, bx]])
        return _estimate_entropy_batch(
            coef, qm16, q, m, cf, coef_h[1][by, bx // 2], distance
        )

    ev_l = mul16 * entropy_v(qys, qxs)
    ev_r = mul16 * entropy_v(qys, qxs + 1)
    eh_t = mul16 * entropy_h(qys, qxs)
    eh_b = mul16 * entropy_h(qys + 1, qxs)

    cost16x8 = np.minimum(ev_l, e8[0, 0] + e8[1, 0]) + np.minimum(
        ev_r, e8[0, 1] + e8[1, 1]
    )
    cost8x16 = np.minimum(eh_t, e8[0, 0] + e8[0, 1]) + np.minimum(
        eh_b, e8[1, 0] + e8[1, 1]
    )

    pick_v = cost16x8 < cost8x16
    for i in range(n):
        qy, qx = qys[i], qxs[i]
        if pick_v[i]:
            if ev_l[i] < e8[0, 0, i] + e8[1, 0, i]:
                _set_strategy(strategy, is_first, qy, qx, C.DCT16X8)
            if ev_r[i] < e8[0, 1, i] + e8[1, 1, i]:
                _set_strategy(strategy, is_first, qy, qx + 1, C.DCT16X8)
        else:
            if eh_t[i] < e8[0, 0, i] + e8[0, 1, i]:
                _set_strategy(strategy, is_first, qy, qx, C.DCT8X16)
            if eh_b[i] < e8[1, 0, i] + e8[1, 1, i]:
                _set_strategy(strategy, is_first, qy + 1, qx, C.DCT8X16)
    return strategy, is_first


def _set_strategy(strategy, is_first, by, bx, typ):
    cy = int(C.COVERED_Y[typ])
    cx = int(C.COVERED_X[typ])
    strategy[by : by + cy, bx : bx + cx] = typ
    is_first[by : by + cy, bx : bx + cx] = False
    is_first[by, bx] = True


def adjust_quant_field(strategy, is_first, raw_qf):
    """AdjustQuantField (enc_ac_strategy.cc:240-266): max over covered cells."""
    out = raw_qf.copy()
    yb, xb = strategy.shape
    for by in range(yb):
        for bx in range(xb):
            if not is_first[by, bx]:
                continue
            t = strategy[by, bx]
            cy, cx = int(C.COVERED_Y[t]), int(C.COVERED_X[t])
            if cy == 1 and cx == 1:
                continue
            m = out[by : by + cy, bx : bx + cx].max()
            out[by : by + cy, bx : bx + cx] = m
    return out
