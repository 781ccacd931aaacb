"""Numpy golden model of the AC group encoder: variable-size DCT, Y-roundtrip
quantization, chroma-from-luma, DC extraction, nonzero contexts, token arrays.

Mirrors WriteACGroup (encoder/enc_group.cc:304-497) but emits fixed-layout
token arrays instead of writing bits inline; packing order is reconstructed by
the packer from the strategy map (see token layout note below).

Token layout: tokens[by, bx, c, 64] u32 = (ctx << 16) | value, with counts
[by, bx, c]. For a first-block cell of a 2-block transform the token sequence
(1 nzeros token + up to 126 coefficient tokens) is split: items 0..63 in the
first cell, 64.. in the continuation cell (the cell below for DCT16X8, to the
right for DCT8X16). Non-first cells of 2-block transforms carry only this
continuation. Emission order is: raster over first-block cells, channels
Y, X, B per block, full sequence per channel.

Frozen copy for the benchmark of jxl_tiny_tpu_torch/ref/group_np.py at
commit 8ebce9c; encode_group also returns the quantized coefficients and
where each value lies at a tie (the benchmark's comparison reads both).
"""
import dataclasses

import numpy as np

from . import constants as C
from .dct_np import dct2d_blocks, dct16x8_from_8, dct8x16_from_8


def _round_away(x):
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def pack_signed(v):
    v = np.asarray(v, np.int64)
    return np.where(v >= 0, 2 * v, -2 * v - 1).astype(np.uint32)


@dataclasses.dataclass
class GroupTokens:
    tokens: np.ndarray  # [yb, xb, 3, 64] uint32: ctx<<16 | value
    counts: np.ndarray  # [yb, xb, 3] int32: valid tokens per cell/channel
    quant_dc: np.ndarray  # [3, yb, xb] int16
    nzeros: np.ndarray  # [3, yb, xb] int32 (stored shifted values)
    quantized: np.ndarray = None  # [3 (X, Y, B), yb, xb, 128] int32


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


def _adjust_quant_bias(q, c):
    """AdjustQuantBias (enc_group.cc:185-218). q: int array."""
    qf = q.astype(np.float32)
    bias = C.DEFAULT_QUANT_BIAS
    small = np.abs(qf) < 1.125
    one_bias = np.where(q == 0, 0.0, np.where(qf < 0, -bias[c], bias[c]))
    with np.errstate(divide="ignore", invalid="ignore"):
        big = qf - bias[3] / qf
    return np.where(small, one_bias, big).astype(np.float32)


def encode_group(
    xyb: np.ndarray,
    strategy: np.ndarray,
    is_first: np.ndarray,
    raw_qf: np.ndarray,
    ytox: np.ndarray,
    ytob: np.ndarray,
    scale: float,
    scale_dc: float,
    x_qm_mul: float,
    xsize_blocks: int,
    ysize_blocks: int,
) -> GroupTokens:
    """xyb: [3, 256, 256] padded group. Only cells < (ysize, xsize)_blocks emit."""
    _, h, w = xyb.shape
    yb, xb = h // 8, w // 8
    scale = np.float32(scale)

    # --- All candidate DCTs (compute-all, select-by-strategy) ---
    coef8 = dct2d_blocks(
        xyb.reshape(3, yb, 8, xb, 8).transpose(0, 1, 3, 2, 4)
    )  # [3, yb, xb, 8, 8]
    # DCT16 families by recombination of the 8x8 DCTs (see dct_np).
    coef_v = dct16x8_from_8(coef8[:, 0::2], coef8[:, 1::2])
    # [3, yb/2, xb, 8, 16]
    coef_h = dct8x16_from_8(coef8[:, :, 0::2], coef8[:, :, 1::2])
    # [3, yb, xb/2, 8, 16]

    # Per-first-cell unified coefficient array [3, yb, xb, 128] (pad DCT8 with 0).
    coefs = np.zeros((3, yb, xb, 128), np.float32)
    sel8 = is_first & (strategy == C.DCT8)
    coefs[:, sel8, :64] = coef8.reshape(3, yb, xb, 64)[:, sel8]
    selv = is_first & (strategy == C.DCT16X8)
    if selv.any():
        by, bx = np.nonzero(selv)
        coefs[:, by, bx, :] = coef_v[:, by // 2, bx].reshape(3, -1, 128)
    selh = is_first & (strategy == C.DCT8X16)
    if selh.any():
        by, bx = np.nonzero(selh)
        coefs[:, by, bx, :] = coef_h[:, by, bx // 2].reshape(3, -1, 128)

    # Strategy-dependent tables per cell.
    strat = strategy.astype(np.int32)
    covered = (C.COVERED_X[strat] * C.COVERED_Y[strat]).astype(np.int32)  # [yb,xb]
    qm = np.zeros((3, yb, xb, 128), np.float32)
    dqm = np.zeros((3, yb, xb, 128), np.float32)
    qm[:, strat == C.DCT8, :64] = C.QUANT_DCT8.reshape(3, 1, 64)
    dqm[:, strat == C.DCT8, :64] = C.DEQUANT_DCT8.reshape(3, 1, 64)
    qm[:, strat != C.DCT8, :] = C.QUANT_DCT16.reshape(3, 1, 128)
    dqm[:, strat != C.DCT8, :] = C.DEQUANT_DCT16.reshape(3, 1, 128)

    # Per-cell zero-bias thresholds [3, yb, xb, 128].
    thr = np.zeros((3, yb, xb, 128), np.float32)
    for c in range(3):
        thr[c, strat == C.DCT8, :64] = threshold_map(c, 1, 1).ravel()
        thr[c, strat == C.DCT16X8, :] = threshold_map(c, 1, 2).ravel()
        thr[c, strat == C.DCT8X16, :] = threshold_map(c, 2, 1).ravel()

    quant = raw_qf.astype(np.float32)  # [yb, xb]
    qac = scale * quant

    # --- Y channel: quantize + roundtrip (enc_group.cc:281-302,392-408) ---
    # Quantizers saturate at the alphabet's value range (C.AC_COEF_CLAMP /
    # C.DC_VALUE_CLAMP; see constants/__init__.py for the derivation).
    clamp = np.float32(C.AC_COEF_CLAMP)
    valy = coefs[1] * qm[1] * qac[..., None]
    qy = np.clip(
        np.where(np.abs(valy) >= thr[1], np.rint(valy), 0.0), -clamp, clamp
    ).astype(np.int32)
    y_deq = (
        _adjust_quant_bias(qy, 1) * dqm[1] * (1.0 / (scale * quant))[..., None]
    ).astype(np.float32)

    # --- DC of Y from original (unquantized) LLF (":396-403") ---
    inv_factor = C.INV_DC_QUANT * np.float32(scale_dc)
    dc_y_f = _dc_from_llf(coefs[1], strat)  # [yb, xb, 2] (per covered cell)
    # quantized Y DC per first cell's covered cells
    dclamp = np.float32(C.DC_VALUE_CLAMP)
    qdc_y_cells = np.clip(
        _round_away(dc_y_f * inv_factor[1]), -dclamp, dclamp
    ).astype(np.int32)

    # --- X, B: CfL unapply using roundtripped Y (":411-425") ---
    tile_fx = (ytox.astype(np.float32) * C.INV_COLOR_FACTOR).repeat(8, 0).repeat(8, 1)[
        :yb, :xb
    ]
    tile_fb = (1.0 + ytob.astype(np.float32) * C.INV_COLOR_FACTOR).repeat(8, 0).repeat(
        8, 1
    )[:yb, :xb]
    coef_x = coefs[0] - tile_fx[..., None] * y_deq
    coef_b = coefs[2] - tile_fb[..., None] * y_deq

    valx = coef_x * qm[0] * (qac * np.float32(x_qm_mul))[..., None]
    qx = np.clip(
        np.where(np.abs(valx) >= thr[0], np.rint(valx), 0.0), -clamp, clamp
    ).astype(np.int32)
    valb = coef_b * qm[2] * qac[..., None]
    qb = np.clip(
        np.where(np.abs(valb) >= thr[2], np.rint(valb), 0.0), -clamp, clamp
    ).astype(np.int32)

    # --- X, B DC (":427-441"); B DC corrected by quantized Y DC ---
    cfl_b = np.float32(C.INV_DC_QUANT[2] * C.DC_QUANT[1])
    dc_x_f = _dc_from_llf(coef_x, strat)
    dc_b_f = _dc_from_llf(coef_b, strat)
    qdc_x_cells = np.clip(
        _round_away(dc_x_f * inv_factor[0]), -dclamp, dclamp
    ).astype(np.int32)
    qdc_b_cells = np.clip(
        _round_away(dc_b_f * inv_factor[2] - qdc_y_cells * cfl_b),
        -dclamp, dclamp,
    ).astype(np.int32)

    # Scatter per-covered-cell DC values into [3, yb, xb].
    quant_dc = np.zeros((3, yb, xb), np.int16)
    for qdc, ch in ((qdc_x_cells, 0), (qdc_y_cells, 1), (qdc_b_cells, 2)):
        quant_dc[ch] = _scatter_covered(qdc, strat, is_first)

    # --- Tokenization ---
    quantized = np.stack([qx, qy, qb])  # [c(X,Y,B), yb, xb, 128]
    gt = _tokenize(
        quantized, strat, is_first, covered, quant_dc, xsize_blocks, ysize_blocks
    )
    gt.quantized = quantized

    # --- Ties (for the benchmark's comparison) ---
    # A value lies at a tie where the number it was rounded from is within
    # TIE_STEPS of a boundary of its quantizer, or where a value it is
    # computed from does: X and B at a position read Y's dequantized value
    # there; the X and B DC read Y's lowest frequencies, and B's DC also
    # Y's quantized DC.
    tie_y = _near_tie(valy, thr[1])
    tie_ac = np.stack([_near_tie(valx, thr[0]) | tie_y, tie_y,
                       _near_tie(valb, thr[2]) | tie_y])
    llf_y = tie_y[..., 0] | (tie_y[..., 1] & (strat != C.DCT8))
    t_dcy = _near_half(dc_y_f * inv_factor[1])
    t_dcx = _near_half(dc_x_f * inv_factor[0]) | llf_y[..., None]
    t_dcb = (_near_half(dc_b_f * inv_factor[2] - qdc_y_cells * cfl_b) | t_dcy
             | llf_y[..., None])
    tie_dc = np.zeros((3, yb, xb), bool)
    for t, ch in ((t_dcx, 0), (t_dcy, 1), (t_dcb, 2)):
        tie_dc[ch] = _scatter_covered(t.astype(np.int16), strat, is_first) != 0
    gt.ties = dict(ac=tie_ac, dc=tie_dc)
    return gt


# How near a boundary, in quantization steps, a value counts as a tie: the
# float32 programs part ways there (operation order, the 8-bit table).
TIE_STEPS = 1e-3
TIE_RELATIVE = 2e-5


def _near_half(v):
    """v rounds half away from zero: within reach of a .5 boundary."""
    a = np.abs(v.astype(np.float64))
    return np.abs(a - np.floor(a) - 0.5) <= TIE_STEPS + TIE_RELATIVE * a


def _near_tie(val, thr):
    """val is zeroed below thr and rounded to nearest above: within reach
    of the threshold or of a .5 boundary."""
    a = np.abs(val.astype(np.float64))
    reach = TIE_STEPS + TIE_RELATIVE * a
    near_half = np.abs(a - np.floor(a) - 0.5) <= reach
    return (np.abs(a - thr) <= reach) | ((a >= thr - reach) & near_half)


def _dc_from_llf(coef, strat):
    """DCFromLowestFrequencies (enc_transforms-inl.h:629-652).

    coef: [yb, xb, 8, 16] or [yb, xb, 128]; returns [yb, xb, 2]: covered-cell DC
    values in (first, second) order (second unused for DCT8).
    """
    coef = coef.reshape(coef.shape[0], coef.shape[1], 128)
    c0 = coef[..., 0]
    c1 = coef[..., 1] * C.DCT_SCALE_16_TO_2
    first = np.where(strat == C.DCT8, c0, c0 + c1)
    second = c0 - c1
    return np.stack([first, second], axis=-1).astype(np.float32)


def _scatter_covered(values, strat, is_first):
    """values: [yb, xb, 2] per-first-cell covered values -> [yb, xb] map."""
    yb, xb = strat.shape
    out = np.zeros((yb, xb), values.dtype)
    f8 = is_first & (strat == C.DCT8)
    out[f8] = values[f8, 0]
    fv = is_first & (strat == C.DCT16X8)
    by, bx = np.nonzero(fv)
    out[by, bx] = values[by, bx, 0]
    out[np.minimum(by + 1, yb - 1), bx] = values[by, bx, 1]
    fh = is_first & (strat == C.DCT8X16)
    by, bx = np.nonzero(fh)
    out[by, bx] = values[by, bx, 0]
    out[by, np.minimum(bx + 1, xb - 1)] = values[by, bx, 1]
    return out.astype(np.int16)


def _tokenize(quantized, strat, is_first, covered, quant_dc, xsize_blocks, ysize_blocks):
    """Context modeling + token arrays (enc_group.cc:443-496)."""
    _, yb, xb, _ = quantized.shape
    valid = np.zeros((yb, xb), bool)
    valid[:ysize_blocks, :xsize_blocks] = True
    first = is_first & valid

    # Zig-zag gather per strategy: ordered coefficients [3, yb, xb, 128].
    order8 = np.concatenate([C.COEFF_ORDER8, 64 + np.arange(64)])  # pad
    order16 = C.COEFF_ORDER16
    order = np.where((strat == C.DCT8)[..., None], order8, order16)  # [yb,xb,128]
    ordered = np.take_along_axis(
        quantized, order[None].repeat(3, 0), axis=-1
    )  # [3, yb, xb, 128]

    size = covered * 64  # [yb, xb]
    log2_cb = (covered > 1).astype(np.int32)

    # nzeros per logical transform, excluding LLF (= first `covered` in order).
    k_idx = np.arange(128)
    in_range = (k_idx[None, None] >= covered[..., None]) & (
        k_idx[None, None] < size[..., None]
    )  # [yb, xb, 128]
    nonzero = (ordered != 0) & in_range[None]
    nzeros_total = nonzero.sum(axis=-1).astype(np.int32)  # [3, yb, xb]
    shifted_nz = -(-nzeros_total // np.maximum(covered, 1))

    # Stored per-cell nzeros map (covered cells all get the shifted value).
    nz_map = np.zeros((3, yb, xb), np.int32)
    for c in range(3):
        nz_map[c] = _scatter_covered(
            np.stack([shifted_nz[c], shifted_nz[c]], -1), strat, is_first
        )

    # Predicted nzeros from top/left cells (enc_group.cc:150-160), default 32.
    pred = np.zeros((3, yb, xb), np.int32)
    top = np.roll(nz_map, 1, axis=1)
    left = np.roll(nz_map, 1, axis=2)
    pred[:, 0, 0] = 32
    pred[:, 0, 1:] = left[:, 0, 1:]
    pred[:, 1:, 0] = top[:, 1:, 0]
    pred[:, 1:, 1:] = (top[:, 1:, 1:] + left[:, 1:, 1:] + 1) // 2

    # Block context (ac_context.h:64-66): map[c][strategy_code].
    strat_code = C.STRATEGY_CODE[strat]  # [yb, xb]
    block_ctx = C.BLOCK_CTX_MAP[:, strat_code]  # [3, yb, xb]

    # NonZeroContext (ac_context.h:107-114).
    p = pred
    nz_bucket = np.where(p < 8, p, np.where(p >= 64, 36, 4 + p // 2))
    nzero_ctx = nz_bucket * C.NUM_BLOCK_CTXS + block_ctx  # [3, yb, xb]

    # Zero-density contexts for every order position (ac_context.h:90-103).
    nz_left = nzeros_total[..., None] - np.cumsum(
        np.where(in_range[None], nonzero, 0), axis=-1
    ) + np.where(in_range[None], nonzero, 0)
    # nz_left[k] = nzeros remaining *before* processing position k.
    prev_nonzero = np.concatenate(
        [np.zeros_like(nonzero[..., :1]), nonzero[..., :-1]], axis=-1
    )
    first_pos = k_idx[None, None, None] == covered[None, ..., None]
    prev_init = (nzeros_total <= (size[None] >> 4)).astype(np.int32)
    prev = np.where(first_pos, prev_init[..., None], prev_nonzero.astype(np.int32))

    nzl_shift = -(-nz_left // np.maximum(covered[None, ..., None], 1))
    k_shift = k_idx[None, None, None] >> log2_cb[None, ..., None]
    zd_ctx = (
        C.COEFF_NNZ_CTX[np.clip(nzl_shift, 0, 63)] + C.COEFF_FREQ_CTX[np.clip(k_shift, 0, 63)]
    ) * 2 + prev
    zd_offset = C.NUM_BLOCK_CTXS * C.NONZERO_BUCKETS + C.ZERO_DENSITY_CONTEXT_COUNT * block_ctx
    coeff_ctx = zd_offset[..., None] + zd_ctx  # [3, yb, xb, 128]

    # Token validity: emit position k iff in_range and nz_left > 0.
    tok_valid = in_range[None] & (nz_left > 0) & first[None, ..., None]

    coeff_val = pack_signed(ordered)

    # Assemble fixed-layout token array: slot 0 = nzeros token, slots 1..
    # = coefficient tokens at order positions covered..127.
    tokens_full = np.zeros((3, yb, xb, 128), np.uint32)
    count_full = np.zeros((3, yb, xb), np.int32)
    # nzeros token
    tokens_full[..., 0] = (nzero_ctx.astype(np.uint32) << 16) | nzeros_total.astype(
        np.uint32
    )
    # coefficient tokens, shifted so position `covered` lands at slot 1.
    # For both covered=1 and covered=2 the shift differs; use gather.
    slot_src = k_idx[None, None] + covered[..., None] - 1  # [yb,xb,128] source pos
    src_oob = slot_src > 127  # covered=2 slot 127 has no source position
    slot_src = np.minimum(slot_src, 127)
    ctx_g = np.take_along_axis(coeff_ctx, slot_src[None].repeat(3, 0), axis=-1)
    val_g = np.take_along_axis(coeff_val, slot_src[None].repeat(3, 0), axis=-1)
    valid_g = np.take_along_axis(tok_valid, slot_src[None].repeat(3, 0), axis=-1)
    valid_g[..., 0] = False  # slot 0 is the nzeros token
    # The clamp above would otherwise duplicate position 127 into slot 127
    # of a 2-block transform when the final zig-zag position is nonzero
    # (only reachable on extreme content that fills every position).
    valid_g &= ~src_oob[None]
    assert (val_g[valid_g] <= 0xFFFF).all(), "token value overflow"
    # slots beyond 1 + (size - covered) are invalid by construction of tok_valid
    tokens_full[valid_g] = (
        (ctx_g[valid_g].astype(np.uint32) << 16) | val_g[valid_g]
    )
    # count = 1 + index of last valid slot (valid slots form a contiguous
    # prefix: the reference loop stops once nzeros is exhausted).
    last_valid = np.where(
        valid_g[..., 1:].any(axis=-1),
        127 - np.argmax(valid_g[..., ::-1], axis=-1),
        0,
    )
    count_full = np.where(first[None], 1 + last_valid, 0).astype(np.int32)

    # Split into per-cell 64-slot arrays (continuation into second cell).
    tokens = np.zeros((yb, xb, 3, 64), np.uint32)
    counts = np.zeros((yb, xb, 3), np.int32)
    tf = tokens_full.transpose(1, 2, 0, 3)  # [yb, xb, 3, 128]
    cf = count_full.transpose(1, 2, 0)  # [yb, xb, 3]
    tokens[first] = tf[first, :, :64]
    counts[first] = np.minimum(cf[first], 64)
    # Continuations: vertical second cell at (by+1, bx); horizontal at (by, bx+1).
    fv = first & (strat == C.DCT16X8)
    by, bx = np.nonzero(fv)
    if len(by):
        tokens[by + 1, bx] = tf[by, bx, :, 64:]
        counts[by + 1, bx] = np.maximum(cf[by, bx] - 64, 0)
    fh = first & (strat == C.DCT8X16)
    by, bx = np.nonzero(fh)
    if len(by):
        tokens[by, bx + 1] = tf[by, bx, :, 64:]
        counts[by, bx + 1] = np.maximum(cf[by, bx] - 64, 0)

    return GroupTokens(
        tokens=tokens, counts=counts, quant_dc=quant_dc, nzeros=nz_map
    )
