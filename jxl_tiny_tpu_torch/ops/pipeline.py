"""Program A of the encode, in torch: N same-sized images (one image: N =
1) -> the device resident token stream, per-image base-64 histograms and
the DC-section layout (analyze_batch_packed).

Counterpart of the JAX package's ops/pipeline_jax.py (analyze_image_packed,
analyze_batch_packed and the stages they run; the port runs one image as a
batch of one). `blocks=True` (EncoderConfig.optimize_block_sizes) runs the
AC-strategy search: the 16x8 / 8x16 coefficient sets, the entropy
estimates of ops/strategy_kernel and the quad decisions; `blocks=False`
makes every cell a DCT8.

`kernels=True` runs the CUDA kernels (ops/*_kernel.py, ops/pack_kernels)
on CUDA tensors; `kernels=False` runs their plain torch versions instead,
which is how chip_smoke.py checks the whole encode against them. On CPU
tensors the kernel wrappers take the plain versions anyway. In debug mode
(utils/debug) NaN checks end the float stages (nan_check: nothing outside
debug mode).

Nothing here reads a value back to the host or copies host data to the
card while the program is queued: the per-size group and DC-group
geometry is made once (group_valid_blocks, dc_geometry) and the constants
live in `tables`, so the host can queue the next image's work while the
card runs this one's.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from ..common import div_ceil
from . import dc_kernels as DK
from .aq_kernel import adaptive_quant_field
from .dct import dct2d_8x8, dct8x16_from_8, dct16x8_from_8
from .pack_kernels import base64_nz, compact_stream, hist_base64
from .quantize_kernel import quantize_cells, quantize_cells_plain, round_away
from .strategy_kernel import (
    combine_partials, estimate_partials, estimate_partials_plain,
)
from .tokenize_kernel import tokenize_cells
from ..tables import canonical_device, to_device
from ..utils.debug import nan_check

F32 = np.float32
_EMIT_CHAN = (1, 0, 2)  # emission channel order Y, X, B


def extract_groups_device(image):
    """[3, H, W] -> [G, 3, 256, 256] f32 edge-replicated group tiles
    (CopyAndPadImage, enc_frame.cc:597-617); [N, 3, H, W] -> [N*G, 3, 256,
    256], each image's groups in turn.

    uint8 input is sRGB-encoded and linearized here (IEC 61966-2-1 EOTF);
    float16 / float32 input is linear and converted to float32."""
    h, w = image.shape[-2:]
    batch = image.reshape(-1, 3, h, w)
    gh = div_ceil(h, 256) * 256
    gw = div_ceil(w, 256) * 256
    if batch.dtype == torch.uint8:
        x = batch.to(torch.float32) * float(F32(1.0 / 255.0))
        lin = torch.exp(
            2.4 * torch.log(
                torch.clamp_min((x + float(F32(0.055))) * float(F32(1.0 / 1.055)), 1e-7)
            )
        )
        batch = torch.where(x <= float(F32(0.04045)), x * float(F32(1.0 / 12.92)), lin)
    else:
        batch = batch.to(torch.float32)
    img = F.pad(batch, (0, gw - w, 0, gh - h), mode="replicate")
    img = img.reshape(-1, 3, gh // 256, 256, gw // 256, 256)
    groups = img.permute(0, 2, 4, 1, 3, 5).reshape(-1, 3, 256, 256).contiguous()
    nan_check("extract_groups", groups)
    return groups


@functools.lru_cache(maxsize=64)
def _group_valid_blocks(ysize, xsize, n_images, device):
    yb = [div_ceil(min(256, ysize - gy * 256), 8)
          for gy in range(div_ceil(ysize, 256)) for _ in range(div_ceil(xsize, 256))]
    xb = [div_ceil(min(256, xsize - gx * 256), 8)
          for _ in range(div_ceil(ysize, 256)) for gx in range(div_ceil(xsize, 256))]
    return tuple(
        to_device(np.tile(np.array(v, np.int32), n_images), device) for v in (yb, xb)
    )


def group_valid_blocks(ysize, xsize, device, n_images=1):
    """(yb_valid, xb_valid) [n_images * G] i32: each group's valid block
    rows and columns, raster order, tiled over the images. Made once a
    size and device (read-only)."""
    return _group_valid_blocks(ysize, xsize, n_images, canonical_device(device))


def _cbrt(v):
    # Cube root through float64 pow, rounded once to float32: torch has no
    # cbrt, and a float32 pow(v, 1/3) misrounds far more often.
    return torch.pow(v.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def to_xyb(groups):
    """[G, 3, 256, 256] linear sRGB -> XYB (enc_xyb.cc:44-81)."""
    m = C.OPSIN_MATRIX
    r, g_, b = groups[:, 0], groups[:, 1], groups[:, 2]
    bias = float(C.OPSIN_BIAS)
    mixed = [
        float(m[i, 0]) * r + float(m[i, 1]) * g_ + float(m[i, 2]) * b + bias
        for i in range(3)
    ]
    nb = float(C.NEG_BIAS_CBRT)
    tm = [_cbrt(torch.clamp_min(v, 0.0)) + nb for v in mixed]
    return torch.stack(
        [0.5 * (tm[0] - tm[1]), 0.5 * (tm[0] + tm[1]), tm[2]], dim=1
    ).contiguous()


def compute_cmap(coef8, valid_blocks, tables):
    """coef8: [G,3,32,32,8,8]; valid_blocks: [G,32,32] bool -> ytox/ytob
    [G,4,4] i32: least-squares chroma-from-luma factors per 64x64 tile
    (enc_chroma_from_luma.cc), weighted by QUANT_DCT8's X and B rows
    (tables.qm8). The tile sums accumulate in float64 and round once to
    float32."""
    g = coef8.shape[0]
    qm_x = tables.qm8[0].reshape(8, 8)
    qm_b = tables.qm8[2].reshape(8, 8)
    vb = valid_blocks[:, :, :, None, None].to(torch.float32)
    m_x = coef8[:, 1] * qm_x * vb
    s_x = coef8[:, 0] * qm_x * vb
    m_b = coef8[:, 1] * qm_b * vb
    s_b = coef8[:, 2] * qm_b * vb

    def tile_sum(a):  # [G,32,32,8,8] -> [G,4,4]
        return a.to(torch.float64).reshape(g, 4, 8, 4, 8, 64).sum(dim=(2, 4, 5)).to(
            torch.float32
        )

    n = valid_blocks.reshape(g, 4, 8, 4, 8).sum(dim=(2, 4)).to(torch.float32) * 64.0

    def fit(m, s, base):
        a = float(C.INV_COLOR_FACTOR) * m
        b = base * m - s
        ca = tile_sum(a * a)
        cb = tile_sum(a * b)
        x = -cb / (ca + n * float(F32(1e-3 * 0.5)) + float(F32(1e-30)))
        return torch.clamp(round_away(x), -128, 127).to(torch.int32)

    return fit(m_x, s_x, 0.0), fit(m_b, s_b, 1.0)


def cfl_factors(ytox, ytob):
    """[G,4,4] i32 tile factors -> (fac_x, fac_b) [G,32,32] f32 cell maps."""
    icf = float(C.INV_COLOR_FACTOR)

    def cells(t):  # [G,4,4] -> [G,32,32], each tile's value on its 8x8 cells
        g = t.shape[0]
        return t.to(torch.float32)[:, :, None, :, None].expand(g, 4, 8, 4, 8).reshape(
            g, 32, 32
        )

    fac_x = cells(ytox) * icf
    fac_b = 1.0 + cells(ytob) * icf
    return fac_x.contiguous(), fac_b.contiguous()


def strategy_inputs(coef8, qf, masking, ytox, ytob, tables):
    """The tensors estimate_partials takes, in its argument order, from the
    8x8 DCTs and the AQ maps. coef8: [G,3,32,32,8,8]; qf/masking:
    [G,32,32] f32. The DCT16-family coefficient sets (items 1 and 2,
    [G,3,16,32,128] and [G,3,32,16,128]) come from the 8x8 DCTs by
    recombination (ops/dct)."""
    g = coef8.shape[0]
    a0, a1 = tables.dct16_a0, tables.dct16_a1
    cpair = coef8.reshape(g, 3, 16, 2, 32, 8, 8)
    coef_v = dct16x8_from_8(cpair[:, :, :, 0], cpair[:, :, :, 1], a0, a1)
    hpair = coef8.reshape(g, 3, 32, 16, 2, 8, 8)
    coef_h = dct8x16_from_8(hpair[:, :, :, :, 0], hpair[:, :, :, :, 1], a0, a1)
    fac8 = torch.stack(cfl_factors(ytox, ytob), dim=1)
    # Vertical candidates take the larger q / masking of rows (2r, 2r+1)
    # and the CfL factor of the top cell; horizontal likewise over columns.
    args = (
        coef8.reshape(g, 3, 32, 32, 64), coef_v.reshape(g, 3, 16, 32, 128),
        coef_h.reshape(g, 3, 32, 16, 128),
        qf, torch.maximum(qf[:, 0::2], qf[:, 1::2]),
        torch.maximum(qf[:, :, 0::2], qf[:, :, 1::2]),
        masking, torch.maximum(masking[:, 0::2], masking[:, 1::2]),
        torch.maximum(masking[:, :, 0::2], masking[:, :, 1::2]),
        fac8, fac8[:, :, 0::2], fac8[:, :, :, 0::2],
    )
    return tuple(a.contiguous() for a in args) + (tables.qm8, tables.qm16)


def strategy_estimates(coef8, qf, masking, ytox, ytob, distance, tables,
                       kernels=True):
    """The three families' cost maps for the quad decisions. Returns (e8
    [G,32,32], ev [G,16,32], eh [G,32,16], coef_v, coef_h)."""
    args = strategy_inputs(coef8, qf, masking, ytox, ytob, tables)
    estimate = estimate_partials if kernels else estimate_partials_plain
    p8, pv, ph = estimate(*args, min(1.0, distance / 3.0))
    mul8 = F32(1.0735757687292623 * 0.75 + (-0.55 * 0.75) / (distance + 1.4))
    mul16 = F32(0.9019587899705066 + (-0.55) / (distance + 1.6))
    e8 = float(F32(3.0) * mul8) + float(mul8) * combine_partials(p8, args[6], 1)
    ev = float(mul16) * combine_partials(pv, args[7], 2)
    eh = float(mul16) * combine_partials(ph, args[8], 2)
    nan_check("strategy_estimates", e8, ev, eh, args[1], args[2])
    return e8, ev, eh, args[1], args[2]


def decide_strategy(e8, ev, eh, yb_valid, xb_valid):
    """Quad decisions from the cost maps (strict < comparisons, as the
    reference). e8: [G,32,32]; ev: [G,16,32]; eh: [G,32,16]; yb_valid /
    xb_valid: [G] valid block dims. Returns (strategy [G,32,32] i32,
    is_first [G,32,32] bool)."""
    g = e8.shape[0]
    dev = e8.device
    e00, e01 = e8[:, 0::2, 0::2], e8[:, 0::2, 1::2]
    e10, e11 = e8[:, 1::2, 0::2], e8[:, 1::2, 1::2]
    ev_l, ev_r = ev[:, :, 0::2], ev[:, :, 1::2]
    eh_t, eh_b = eh[:, 0::2], eh[:, 1::2]
    cost16x8 = torch.minimum(ev_l, e00 + e10) + torch.minimum(ev_r, e01 + e11)
    cost8x16 = torch.minimum(eh_t, e00 + e01) + torch.minimum(eh_b, e10 + e11)
    pick_v = cost16x8 < cost8x16
    qi = torch.arange(16, device=dev)
    quad_ok = (2 * qi[None, :, None] + 2 <= yb_valid[:, None, None]) & (
        2 * qi[None, None, :] + 2 <= xb_valid[:, None, None]
    )
    vfirst = torch.zeros((g, 32, 32), dtype=torch.bool, device=dev)
    hfirst = torch.zeros((g, 32, 32), dtype=torch.bool, device=dev)
    vfirst[:, 0::2, 0::2] = quad_ok & pick_v & (ev_l < e00 + e10)
    vfirst[:, 0::2, 1::2] = quad_ok & pick_v & (ev_r < e01 + e11)
    hfirst[:, 0::2, 0::2] = quad_ok & ~pick_v & (eh_t < e00 + e01)
    hfirst[:, 1::2, 0::2] = quad_ok & ~pick_v & (eh_b < e10 + e11)
    second_v = DK.shift0(vfirst, -1, -2)
    second_h = DK.shift0(hfirst, -1, -1)
    strategy = torch.where(
        vfirst | second_v, C.DCT16X8,
        torch.where(hfirst | second_h, C.DCT8X16, C.DCT8),
    ).to(torch.int32)
    return strategy, ~(second_v | second_h)


def compute_ac_strategy(coef8, qf, masking, ytox, ytob, distance, yb_valid,
                        xb_valid, tables, kernels=True):
    """The AC-strategy search. Returns (strategy [G,32,32] i32, is_first
    [G,32,32] bool, coef_v [G,3,16,32,128], coef_h [G,3,32,16,128])."""
    e8, ev, eh, coef_v, coef_h = strategy_estimates(
        coef8, qf, masking, ytox, ytob, distance, tables, kernels
    )
    strategy, is_first = decide_strategy(e8, ev, eh, yb_valid, xb_valid)
    return strategy, is_first, coef_v, coef_h


def adjust_quant_field(strategy, is_first, raw_qf):
    """Both cells of a two-cell transform take the larger raw_qf of the
    pair."""
    vfirst = is_first & (strategy == C.DCT16X8)
    hfirst = is_first & (strategy == C.DCT8X16)
    m_v = torch.maximum(raw_qf, DK.shift0(raw_qf, 1, -2))
    m_h = torch.maximum(raw_qf, DK.shift0(raw_qf, 1, -1))
    out = torch.where(vfirst, m_v, raw_qf)
    out = torch.where(DK.shift0(vfirst, -1, -2), DK.shift0(m_v, -1, -2), out)
    out = torch.where(hfirst, m_h, out)
    out = torch.where(DK.shift0(hfirst, -1, -1), DK.shift0(m_h, -1, -1), out)
    return out


def _scatter_covered(values, strat, is_first):
    """values: [G,yb,xb,2] per-first-cell -> [G,yb,xb] cell map."""
    vfirst = is_first & (strat == C.DCT16X8)
    hfirst = is_first & (strat == C.DCT8X16)
    out = torch.where(is_first, values[..., 0], 0)
    out = torch.where(DK.shift0(vfirst, -1, -2), DK.shift0(values[..., 1], -1, -2), out)
    out = torch.where(DK.shift0(hfirst, -1, -1), DK.shift0(values[..., 1], -1, -1), out)
    return out


def encode_middle(coef8, coef_v, coef_h, strategy, is_first, raw_qf, ytox,
                   ytob, scale, scale_dc, x_qm_mul, tables, kernels):
    """Quantize kernel + the neighbour-dependent context math on the
    [G,3,32,32] maps (the JAX package's _encode_middle). `ordered` is in
    emission layout [G,32,32,3,128] (channels Y, X, B); every other map is
    channel-major [G,3,32,32] (X, Y, B), `nzero_ctx` in the base-64
    clustering (pack_kernels.base64_nz)."""
    fac_x, fac_b = cfl_factors(ytox, ytob)
    quant = quantize_cells if kernels else quantize_cells_plain
    ordered, nzeros_total, qdcp, lastnz = quant(
        coef8.reshape(coef8.shape[0], 3, 32, 32, 64).contiguous(), coef_v, coef_h,
        strategy.to(torch.int32).contiguous(), raw_qf.to(torch.int32).contiguous(),
        fac_x, fac_b, tables, scale, scale_dc, x_qm_mul,
    )
    quant_dc = torch.stack(
        [
            _scatter_covered(qdcp[:, c].permute(0, 2, 3, 1), strategy, is_first)
            for c in range(3)
        ],
        dim=1,
    )  # [G,3,32,32]
    covered = torch.where(strategy == C.DCT8, 1, 2)
    shifted_nz = -torch.div(
        -nzeros_total, torch.clamp_min(covered[:, None], 1), rounding_mode="floor"
    )
    nz_map = torch.stack(
        [
            _scatter_covered(
                torch.stack([shifted_nz[:, c]] * 2, -1), strategy, is_first
            )
            for c in range(3)
        ],
        dim=1,
    )
    top = DK.shift0(nz_map, -1, -2)
    left = DK.shift0(nz_map, -1, -1)
    by_i = torch.arange(32, device=coef8.device)[:, None]
    bx_i = torch.arange(32, device=coef8.device)[None, :]
    pred = torch.where(
        (by_i == 0) & (bx_i == 0),
        32,
        torch.where(
            by_i == 0, left,
            torch.where(bx_i == 0, top, torch.div(top + left + 1, 2, rounding_mode="floor")),
        ),
    )
    block_ctx = tables.block_ctx_tab[strategy.long()].permute(0, 3, 1, 2)  # [G,3,32,32]
    nz_bucket = torch.where(
        pred < 8, pred,
        torch.where(pred >= 64, 36, 4 + torch.div(pred, 2, rounding_mode="floor")),
    )
    nzero_ctx = base64_nz(nz_bucket, block_ctx)
    size_b = (covered * 64)[:, None]
    prev_init = (nzeros_total <= (size_b >> 4)).to(torch.int32)
    return dict(
        ordered=ordered, nzeros_total=nzeros_total, lastnz=lastnz,
        covered=covered, block_ctx=block_ctx, nz_bucket=nz_bucket,
        nzero_ctx=nzero_ctx, prev_init=prev_init, quant_dc=quant_dc, nz_map=nz_map,
    )


def encode_groups_stream(coef8, coef_v, coef_h, strategy, is_first, raw_qf,
                         ytox, ytob, scale, scale_dc, x_qm_mul, valid, cap,
                         tables, kernels=True):
    """Quantize + contexts + tokenize + compaction.

    Returns (stream [G, cap+128] i32, totals [G] i64, quant_dc [G,3,32,32])."""
    g = coef8.shape[0]
    first = is_first & valid
    m = encode_middle(
        coef8, coef_v, coef_h, strategy, is_first, raw_qf, ytox, ytob,
        scale, scale_dc, x_qm_mul, tables, kernels,
    )
    shp = m["nzeros_total"].shape
    covered_b = m["covered"][:, None].expand(shp)
    first_b = first[:, None].expand(shp)

    def em(a):  # [G,3,32,32] map -> emission order [G,32,32,3]
        # Stacked slices, not a[:, list]: indexing with a list copies the
        # list to the card and waits for it.
        return torch.stack([a[:, c] for c in _EMIT_CHAN], dim=3)

    tokens_em = tokenize_cells(
        m["ordered"], em(covered_b), em(m["nzeros_total"]), em(m["block_ctx"]),
        em(m["nzero_ctx"]), em(m["prev_init"]), em(first_b), tables, kernels,
    )
    # Per-cell token counts from the quantizer's lastnz: the last valid
    # coefficient token sits at slot lastnz - covered + 1.
    count_em = torch.where(
        em(first_b),
        1 + torch.clamp_min(em(m["lastnz"]) - em(covered_b) + 1, 0),
        0,
    ).to(torch.int32)
    stream, totals = compact_stream(
        tokens_em.reshape(g, -1, 128), count_em.reshape(g, -1), cap, kernels
    )
    return stream, totals, m["quant_dc"]


def analysis_front(groups, yb_valid, xb_valid, distp, tables, cfl=True, blocks=True,
                   kernels=True):
    """The decisions every analysis shares, on [G, 3, 256, 256] linear
    groups: XYB, the AQ field, the 8x8 DCTs, CfL, the AC-strategy search
    and the adjusted quant field. Returns dict(coef8 [G,3,32,32,8,8],
    coef_v, coef_h, strategy, is_first, raw_qf, ytox, ytob, valid [G,32,32]
    bool)."""
    g = groups.shape[0]
    dev = groups.device
    xyb = to_xyb(groups.to(torch.float32))
    nan_check("to_xyb", xyb)
    qf, masking, raw_qf = adaptive_quant_field(
        xyb, distp.distance, distp.inv_scale, kernels
    )
    nan_check("adaptive_quant_field", qf, masking)
    blocks8 = xyb.reshape(g, 3, 32, 8, 32, 8).permute(0, 1, 2, 4, 3, 5)
    coef8 = dct2d_8x8(blocks8, tables.dct8)
    nan_check("dct2d_8x8", coef8)
    by_i = torch.arange(32, device=dev)[:, None]
    bx_i = torch.arange(32, device=dev)[None, :]
    valid = (by_i[None] < yb_valid[:, None, None]) & (bx_i[None] < xb_valid[:, None, None])
    if cfl:
        ytox, ytob = compute_cmap(coef8, valid, tables)
    else:
        ytox = torch.zeros((g, 4, 4), dtype=torch.int32, device=dev)
        ytob = torch.zeros((g, 4, 4), dtype=torch.int32, device=dev)
    if blocks:
        strategy, is_first, coef_v, coef_h = compute_ac_strategy(
            coef8, qf, masking, ytox, ytob, distp.distance, yb_valid, xb_valid,
            tables, kernels,
        )
        raw_qf = adjust_quant_field(strategy, is_first, raw_qf)
    else:
        strategy = torch.zeros((g, 32, 32), dtype=torch.int32, device=dev)
        is_first = torch.ones((g, 32, 32), dtype=torch.bool, device=dev)
        # The quantizer's 16x8 / 8x16 inputs are never selected with every
        # cell a DCT8; empty tensors of the right shape keep its contract.
        coef_v = torch.zeros((g, 3, 16, 32, 128), dtype=torch.float32, device=dev)
        coef_h = torch.zeros((g, 3, 32, 16, 128), dtype=torch.float32, device=dev)
    return dict(coef8=coef8, coef_v=coef_v, coef_h=coef_h, strategy=strategy,
                is_first=is_first, raw_qf=raw_qf, ytox=ytox, ytob=ytob, valid=valid)


def analyze_groups_packed(groups, yb_valid, xb_valid, distp, cap, tables,
                          cfl=True, blocks=True, kernels=True, n_images=1):
    """Group-batch core of program A over n_images images' groups in turn.
    Returns dict of stream, totals, hist ([n_images, 64, 64]) and maps (the
    per-group maps the DC layout is built from)."""
    f = analysis_front(groups, yb_valid, xb_valid, distp, tables, cfl, blocks, kernels)
    strategy, is_first, raw_qf, ytox, ytob = (
        f[k] for k in ("strategy", "is_first", "raw_qf", "ytox", "ytob"))
    stream, totals, quant_dc = encode_groups_stream(
        f["coef8"], f["coef_v"], f["coef_h"], strategy, is_first, raw_qf, ytox, ytob,
        distp.scale, distp.scale_dc, distp.x_qm_mul, f["valid"], cap, tables, kernels,
    )
    hist = hist_base64(stream[:, :cap], torch.clamp_max(totals, cap), n_images)
    return dict(
        stream=stream, totals=totals, hist=hist,
        maps=(quant_dc, raw_qf, strategy, is_first, ytox, ytob),
    )


def analyze_batch_packed(images, yb_valid, xb_valid, distp, cap, tables,
                         cfl=True, blocks=True, kernels=True):
    """Program A: N same-sized images [N, 3, H, W] (one image: N = 1) in
    one pass over their N*G groups (each kernel launches once, not N
    times), with one histogram an image. yb_valid / xb_valid: [N*G]
    (group_valid_blocks with n_images=N). Returns dict(stream [N*G,
    cap+128] i32, totals [N*G] i64, hists [N, 2, 64, 64] i64 (AC base-64,
    DC), dc_layout [N*Gd, DC_CAP] i32)."""
    n = images.shape[0]
    out = analyze_groups_packed(
        extract_groups_device(images), yb_valid, xb_valid, distp, cap, tables,
        cfl, blocks, kernels, n_images=n,
    )
    layout, dchists = dc_layout_from_maps(
        *out["maps"], ysize=images.shape[-2], xsize=images.shape[-1],
        tables=tables, n_images=n,
    )
    return dict(
        stream=out["stream"], totals=out["totals"],
        hists=torch.stack([out["hist"], dchists], dim=1), dc_layout=layout,
    )


@functools.lru_cache(maxsize=64)
def _dc_geometry(ysize, xsize, n_images, device):
    geo = DK.dc_group_geometry(ysize, xsize)
    return tuple(
        to_device(np.tile(np.array(geo[k], np.int32), n_images), device)
        for k in ("ydb", "xdb", "ty", "tx", "nb")
    )


def dc_geometry(ysize, xsize, device, n_images=1):
    """Per-DC-group valid dims (ydb, xdb, ty, tx, nb; see
    dc_kernels.dc_group_geometry) as int32 tensors [n_images * Gd], made
    once a size and device (read-only), so that building the layout copies
    nothing to the card."""
    return _dc_geometry(ysize, xsize, n_images, canonical_device(device))


def dc_planes(quant_dc, raw_qf, strategy, is_first, ytox, ytob, ysize, xsize,
              n_images=1):
    """Per-group maps of n_images same-sized images (each image's groups in
    turn) -> the six DC-group planes build_dc_layout takes, [N*Gd, ...]
    (is_first bool, the rest int32). The maps are regrouped as int32, as in
    the JAX package."""
    ygr = div_ceil(ysize, 256)
    xgr = div_ceil(xsize, 256)
    ygr_p = div_ceil(ygr, 8) * 8
    xgr_p = div_ceil(xgr, 8) * 8

    def regroup(a, trailing):
        a = a.reshape((n_images, ygr, xgr) + tuple(a.shape[1:])).to(torch.int32)
        pad = [0, 0] * (a.dim() - 3) + [0, xgr_p - xgr, 0, ygr_p - ygr]
        a = F.pad(a, pad)
        a = a.reshape((n_images * ygr_p * xgr_p,) + tuple(a.shape[3:]))
        return DK.regroup_dc(a, ygr_p, xgr_p, trailing, n_images)

    return (regroup(quant_dc, True), regroup(raw_qf, False), regroup(strategy, False),
            regroup(is_first, False).to(torch.bool), regroup(ytox, False),
            regroup(ytob, False))


def dc_layout_from_maps(quant_dc, raw_qf, strategy, is_first, ytox, ytob,
                        ysize, xsize, tables, n_images=1):
    """Per-group maps of n_images same-sized images (each image's groups in
    turn) -> DC-section layout [N*Gd, DC_CAP] i32 + per-image DC histograms
    [N, 64, 64]."""
    layout = DK.build_dc_layout(
        *dc_planes(quant_dc, raw_qf, strategy, is_first, ytox, ytob, ysize, xsize,
                   n_images),
        *dc_geometry(ysize, xsize, quant_dc.device, n_images), tables,
    )
    return layout, DK.dc_hist(layout, n_images)
