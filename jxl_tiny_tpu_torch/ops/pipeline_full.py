"""The full-context analysis on the card: [G, 3, 256, 256] groups -> token
arrays over all 1980 AC contexts, for the host-packed path
(encoder.encode_image_host_packed), whose host clusters and packs them.

Counterpart of the JAX package's ops/pipeline_jax.py encode_groups,
split_token_cells, compact_token_stream, token_histogram,
analyze_groups_jax, analyze_image_fast, analyze_groups_fast and
make_analyze_fn. The decisions (XYB, the AQ field, the DCTs, CfL, the
AC-strategy search) are program A's (ops/pipeline.analysis_front), so the
AQ and strategy kernels run here as there. The full-context quantizer and
tokenizer are plain torch ops, as the JAX package computes them outside any
Pallas kernel; `encode_groups(base_ctx=True)` composes the quantize and
tokenize kernels instead (program A's base-64 form).

Tokens are `ctx << 16 | value` with ctx < 1980: 27 bits, held in int32
tensors (the port's u32-as-int32 convention); the host reads them as
uint32. `kernels=False` runs the plain versions of the AQ and strategy
kernels (and of quantize / tokenize in the base-64 form), to check them on
the card.
"""
import numpy as np
import torch

from .. import constants as C
from ..common import div_ceil
from ..tables import _nnz_ctx_steps
from . import dc_kernels as DK
from . import pipeline as PL
from .pack_kernels import count_bins, uint_token_extra
from .tokenize_kernel import tokenize_cells

_EMIT_CHAN = (1, 0, 2)  # emission channel order Y, X, B (its own inverse)
_NNZ_STEPS = tuple(zip(*(a.tolist() for a in _nnz_ctx_steps())))
# The stream length an analysis is re-run at when a group overflows the
# requested cap (encoder.encode_image_host_packed; the JAX package's rule).
FULL_CAP = 3 * 64 * 1024


def encode_groups(coef8, coef_v, coef_h, strategy, is_first, raw_qf, ytox, ytob,
                  scale, scale_dc, x_qm_mul, valid, tables, base_ctx=False,
                  kernels=True):
    """Quantize + tokenize (ref/group_np.encode_group, batched).

    Returns (tokens_full [G,3,32,32,128] i32: lane 0 the nzeros token, lane
    t >= 1 the coefficient token of zig-zag position covered + t - 1;
    count_full [G,3,32,32] i32; quant_dc [G,3,32,32] i32; nz_map
    [G,3,32,32] i32), channels X, Y, B. base_ctx=False: full contexts
    (0..1979), plain torch; base_ctx=True: the base-64 contexts of the
    device-packed path, from the quantize and tokenize kernels."""
    first = is_first & valid
    m = PL.encode_middle(
        coef8, coef_v, coef_h, strategy, is_first, raw_qf, ytox, ytob,
        scale, scale_dc, x_qm_mul, tables, kernels=kernels and base_ctx,
    )
    shp = m["nzeros_total"].shape
    covered_b = m["covered"][:, None].expand(shp)
    first_b = first[:, None].expand(shp)
    # Channel-major zig-zag values [G,3,32,32,128] (X, Y, B).
    ordered = m["ordered"].permute(0, 3, 1, 2, 4)
    ordered = torch.stack([ordered[:, c] for c in _EMIT_CHAN], dim=1)
    if base_ctx:
        tokens_full = tokenize_cells(
            ordered, covered_b, m["nzeros_total"], m["block_ctx"], m["nzero_ctx"],
            m["prev_init"], first_b, tables, kernels,
        )
        slot = torch.arange(128, device=ordered.device)
        last_valid = torch.where((tokens_full != 0) & (slot >= 1), slot, 0).amax(dim=-1)
        count_full = torch.where(first_b, 1 + last_valid, 0).to(torch.int32)
        return tokens_full, count_full, m["quant_dc"], m["nz_map"]
    tokens_full, count_full = _tokenize_full(
        ordered, m["covered"], m["nzeros_total"], m["block_ctx"], m["nz_bucket"],
        m["prev_init"], first, tables,
    )
    return tokens_full, count_full, m["quant_dc"], m["nz_map"]


def _tokenize_full(ordered, covered, nzeros_total, block_ctx, nz_bucket, prev_init,
                   first, tables):
    """The full-context token arrays (pipeline_jax.encode_groups' tail)."""
    k_idx = torch.arange(128, device=ordered.device)
    size = covered * 64
    cov2 = (covered > 1)[:, None, :, :, None]  # [G,1,32,32,1]
    in_range = ((k_idx >= covered[..., None]) & (k_idx < size[..., None]))[:, None]
    nonzero = ((ordered != 0) & in_range).to(torch.int32)
    nz_left = (nzeros_total[..., None] - torch.cumsum(nonzero, -1, dtype=torch.int32)
               + nonzero)
    prev_nonzero = DK.shift0(nonzero, -1, -1)
    first_pos = k_idx == covered[:, None, :, :, None]
    prev = torch.where(first_pos, prev_init[..., None], prev_nonzero)
    # COEFF_NNZ_CTX as a monotone step function of ceil(nz_left / covered).
    nzl_shift = -torch.div(-nz_left, covered[:, None, ..., None], rounding_mode="floor")
    nnz_part = torch.zeros_like(nzl_shift)
    for t, d in _NNZ_STEPS:
        nnz_part = nnz_part + torch.where(nzl_shift >= t, d, 0)
    freq_part = torch.where(cov2, tables.freq_tab[1], tables.freq_tab[0])
    zd_ctx = (nnz_part + freq_part) * 2 + prev
    zd_offset = (C.NUM_BLOCK_CTXS * C.NONZERO_BUCKETS
                 + C.ZERO_DENSITY_CONTEXT_COUNT * block_ctx)
    coeff_ctx = zd_offset[..., None] + zd_ctx
    tok_valid = (in_range & (nz_left > 0)) & first[:, None, :, :, None]
    coeff_val = torch.where(ordered >= 0, 2 * ordered, -2 * ordered - 1)

    def shift_sel(a):  # covered=2: slot t reads position t + 1, 0 past the row
        return torch.where(cov2, DK.shift0(a, 1, -1), a)

    slot0 = k_idx == 0
    valid_g = shift_sel(tok_valid) & ~slot0
    packed = torch.where(valid_g, (shift_sel(coeff_ctx) << 16) | shift_sel(coeff_val), 0)
    nzero_ctx = nz_bucket * C.NUM_BLOCK_CTXS + block_ctx
    nz_token = (nzero_ctx << 16) | nzeros_total
    tokens_full = torch.where(slot0, nz_token[..., None], packed).to(torch.int32)
    last_valid = torch.where(valid_g, k_idx, 0).amax(dim=-1)
    count_full = torch.where(first[:, None], 1 + last_valid, 0).to(torch.int32)
    return tokens_full, count_full


def split_token_cells(tokens_full, count_full, strategy, is_first, valid):
    """The per-cell 64-slot layout of the numpy golden model: (tokens
    [G,32,32,3,64] i32, counts [G,32,32,3] i32); a two-cell transform's
    slots 64.. go to its second cell (below for 16x8, right for 8x16)."""
    first = is_first & valid
    tf = tokens_full.permute(0, 2, 3, 1, 4)  # [G,32,32,3,128]
    cf = count_full.permute(0, 2, 3, 1)  # [G,32,32,3]
    sec_v = DK.shift0(first & (strategy == C.DCT16X8), -1, 1)
    sec_h = DK.shift0(first & (strategy == C.DCT8X16), -1, 2)
    tokens = torch.where(first[..., None, None], tf[..., :64], 0)
    counts = torch.where(first[..., None], torch.clamp_max(cf, 64), 0)
    tokens = torch.where(sec_v[..., None, None], DK.shift0(tf[..., 64:], -1, 1), tokens)
    tokens = torch.where(sec_h[..., None, None], DK.shift0(tf[..., 64:], -1, 2), tokens)
    counts = torch.where(sec_v[..., None], torch.clamp_min(DK.shift0(cf, -1, 1) - 64, 0),
                         counts)
    counts = torch.where(sec_h[..., None], torch.clamp_min(DK.shift0(cf, -1, 2) - 64, 0),
                         counts)
    return tokens.to(torch.int32), counts.to(torch.int32)


def compact_token_stream(tokens_full, count_full, cap):
    """The emission-ordered token stream of each group: (stream [G, cap]
    i32, totals [G] i32). Emission is the reference's WriteACGroup order:
    raster over first cells, channels Y, X, B, the transform's full token
    sequence per channel. Positions past a group's total are zero; a group
    with more than `cap` tokens is cut at cap (its total stays exact).

    Each output position finds its row by a binary search over the row
    ends and gathers its token (no scatter)."""
    g = tokens_full.shape[0]
    em = [tokens_full[:, c] for c in _EMIT_CHAN]
    rows_tok = torch.stack(em, dim=3).reshape(g, -1)  # [G, 3072 * 128]
    rows_cnt = torch.stack([count_full[:, c] for c in _EMIT_CHAN], dim=3).reshape(g, -1)
    ends = torch.cumsum(rows_cnt, dim=1, dtype=torch.int64)
    totals = ends[:, -1]
    starts = ends - rows_cnt
    pos = torch.arange(cap, device=tokens_full.device).expand(g, cap).contiguous()
    r = torch.clamp_max(torch.searchsorted(ends, pos, right=True), rows_cnt.shape[1] - 1)
    slot = torch.clamp(pos - torch.gather(starts, 1, r), 0, 127)
    val = torch.gather(rows_tok, 1, r * 128 + slot)
    stream = torch.where(pos < totals[:, None], val, 0)
    return stream, totals.to(torch.int32)


def token_histogram(tokens_full, count_full):
    """[G,3,32,32,128] tokens -> the AC histogram [1980, 64] i64 of (context,
    hybrid-uint token) over each cell's first count_full slots. An integer
    sum: the same for any split of the groups."""
    t = tokens_full.to(torch.int64).reshape(-1, 128)
    valid = torch.arange(128, device=t.device) < count_full.reshape(-1, 1)
    tok, _, _ = uint_token_extra(t & 0xFFFF)
    # One row: count_bins' row a cell would need [cells, 126,721] counters.
    bins = torch.where(valid, (t >> 16) * C.ALPHABET_SIZE + tok, 0).reshape(1, -1)
    hist = count_bins(bins, valid.reshape(1, -1), C.NUM_AC_CONTEXTS * C.ALPHABET_SIZE)
    return hist.reshape(C.NUM_AC_CONTEXTS, C.ALPHABET_SIZE)


def _analyze(groups, yb_valid, xb_valid, distp, tables, kernels):
    f = PL.analysis_front(groups, yb_valid, xb_valid, distp, tables, kernels=kernels)
    tokens_full, count_full, quant_dc, _ = encode_groups(
        f["coef8"], f["coef_v"], f["coef_h"], f["strategy"], f["is_first"],
        f["raw_qf"], f["ytox"], f["ytob"], distp.scale, distp.scale_dc,
        distp.x_qm_mul, f["valid"], tables, kernels=kernels,
    )
    return f, tokens_full, count_full, quant_dc


def _maps(f, quant_dc):
    return dict(
        quant_dc=quant_dc.to(torch.int16), strategy=f["strategy"].to(torch.uint8),
        is_first=f["is_first"], raw_qf=f["raw_qf"].to(torch.uint8),
        ytox=f["ytox"].to(torch.int8), ytob=f["ytob"].to(torch.int8),
    )


def analyze_groups(groups, yb_valid, xb_valid, distp, tables, kernels=True,
                   with_hist=False):
    """groups: [G,3,256,256] linear sRGB (edge-padded); yb_valid / xb_valid:
    [G] i32 valid block dims. Returns dict(tokens [G,32,32,3,64], counts
    [G,32,32,3], quant_dc, strategy, is_first, raw_qf, ytox, ytob), the
    per-cell token layout of the numpy golden model (analyze_groups_jax);
    with_hist adds hist, token_histogram of the groups."""
    f, tokens_full, count_full, quant_dc = _analyze(groups, yb_valid, xb_valid, distp,
                                                    tables, kernels)
    tokens, counts = split_token_cells(tokens_full, count_full, f["strategy"],
                                       f["is_first"], f["valid"])
    out = dict(tokens=tokens, counts=counts, **_maps(f, quant_dc))
    if with_hist:
        out["hist"] = token_histogram(tokens_full, count_full)
    return out


def analyze_groups_fast(groups, yb_valid, xb_valid, distp, cap, tables, kernels=True,
                        with_hist=False):
    """The transfer-lean form: the token arrays stay on the device, and the
    outputs are the compact emission-ordered streams (stream [G, cap] i32,
    totals [G] i32) and the small per-block maps; with_hist adds hist,
    token_histogram of the groups."""
    f, tokens_full, count_full, quant_dc = _analyze(groups, yb_valid, xb_valid, distp,
                                                    tables, kernels)
    stream, totals = compact_token_stream(tokens_full, count_full, cap)
    out = dict(stream=stream, totals=totals, **_maps(f, quant_dc))
    if with_hist:
        out["hist"] = token_histogram(tokens_full, count_full)
    return out


def join_f16_planes(planes):
    """[2, 3, H, W] u8 byte planes (high, low) of float16 pixels -> [3, H,
    W] float16."""
    bits = (planes[0].to(torch.int32) << 8) | planes[1].to(torch.int32)
    return torch.where(bits >= 32768, bits - 65536, bits).to(torch.int16).view(
        torch.float16)


def analyze_image_fast(image, yb_valid, xb_valid, distp, cap, tables, kernels=True):
    """analyze_groups_fast of a whole [3, H, W] image, tiled on the device:
    float32 or float16 (linear), u8 (sRGB samples, linearized on the
    device) or [2, 3, H, W] u8 byte planes of float16 pixels."""
    if image.dim() == 4:
        image = join_f16_planes(image)
    return analyze_groups_fast(PL.extract_groups_device(image), yb_valid, xb_valid,
                               distp, cap, tables, kernels)


def make_analyze_fn(device=None, tables=None, kernels=True):
    """An analyze function for encoder.encode_image (analyze_fn=): each
    group alone through analyze_groups on `device` (None: the CUDA card,
    raising without one), returned as an encoder.GroupResult."""
    from ..encoder import GroupResult, _extract_group
    from ..ref.group_np import GroupTokens
    from ..tables import device_tables
    from ..transfer import resolve_device

    device = resolve_device(device)
    tables = device_tables(device) if tables is None else tables

    def analyze(img, gx, gy, distp):
        _, h, w = img.shape
        yb = div_ceil(min(256, h - gy * 256), 8)
        xb = div_ceil(min(256, w - gx * 256), 8)
        patch = torch.from_numpy(np.ascontiguousarray(_extract_group(img, gx, gy)[None]))
        out = analyze_groups(
            patch.to(device), torch.tensor([yb], dtype=torch.int32).to(device),
            torch.tensor([xb], dtype=torch.int32).to(device), distp, tables, kernels,
        )
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        ty, tx = div_ceil(yb, 8), div_ceil(xb, 8)
        gt = GroupTokens(tokens=out["tokens"].view(np.uint32), counts=out["counts"],
                         quant_dc=out["quant_dc"], nzeros=None)
        return GroupResult(gt, out["strategy"], out["is_first"], out["raw_qf"],
                           out["ytox"][:ty, :tx], out["ytob"][:ty, :tx], yb, xb)

    return analyze
