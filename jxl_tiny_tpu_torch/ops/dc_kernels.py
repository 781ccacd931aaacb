"""Device-side DC-group sections (DC tokens + AC metadata), plain torch.

Counterpart of the JAX package's ops/dc_kernels.py, which has no Pallas
kernel of its own: the DC-section layout, its histogram and program B's
packing (which reaches the compaction kernels through
pack_kernels.bitpack_groups_words and compact_sections).

Mirrors WriteDCGroup (enc_frame.cc:536-570): per DC group, the section is
  header bits | DC tokens (clamped-gradient-predicted, channels Y,X,B)
  | nonzero-count bits | ytox/ytob gradient tokens | AC-strategy tokens
  | quant-field delta tokens | EPF tokens
as a fixed flat layout of 32-bit entries per DC group:
  tag < 45          token: DC/meta context id, value = token value
  tag = 0x8000|n    raw bits: emit value as n literal bits
  tag = 0xFFFF      padding: zero width
Entries are built in int64 and stored as int32 bit patterns.
"""
import torch

from ..common import div_ceil
from ..constants import DC_PAD as PAD
from ..constants import DC_RAW as RAW
from .pack_kernels import (
    bitpack_groups_words, compact_sections, count_bins, pack_ac_sections,
    table_lookup, u32_to_i32, uint_token_extra,
)

PD = 256  # DC-group plane dim in blocks (2048 px / 8)

_HDR = 2
_DCN = 3 * PD * PD
_CMAPN = 2 * 32 * 32
LAYOUT = _HDR + _DCN + 2 + _CMAPN + 3 * PD * PD
DC_CAP = -(-LAYOUT // 4096) * 4096


def gradient_ctx(grad, tables):
    """DC gradient context ids from the step tables of GRADIENT_CTX_LUT:
    base + the deltas of every threshold the clamped distance reaches."""
    d = torch.clamp(grad, -512, 511)
    ctx = torch.full_like(d, tables.grad_base0)
    for t, dl, dist in (
        (tables.grad_pos_t, tables.grad_pos_d, torch.clamp_min(d, 0)),
        (tables.grad_neg_t, tables.grad_neg_d, torch.clamp_min(-d, 0)),
    ):
        cum = torch.cat([dl.new_zeros(1), torch.cumsum(dl, 0)]).to(d.dtype)
        ctx = ctx + cum[torch.searchsorted(t.to(d.dtype), dist, right=True)]
    return ctx


def _pack_signed(v):
    return torch.where(v >= 0, 2 * v, -2 * v - 1)


def shift0(a, d, axis):
    """out[i] = a[i + d] along axis (d != 0), zero fill."""
    n = a.shape[axis]
    z = torch.zeros_like(a.narrow(axis, 0, abs(d)))
    if d > 0:
        return torch.cat([a.narrow(axis, d, n - d), z], dim=axis)
    return torch.cat([z, a.narrow(axis, 0, n + d)], dim=axis)


def gradient_tokens(plane, tables):
    """Clamped-gradient prediction (enc_frame.cc:287-316) on [Gd, H, W]
    planes. Returns (ctx, packed residual) at every position. Left of column
    0 is the previous row's column 0; row 0 uses left as top/topleft."""
    p = plane.to(torch.int64)
    left = shift0(p, -1, 2)
    col0 = shift0(p[:, :, 0], -1, 1)
    left = torch.cat([col0[:, :, None], left[:, :, 1:]], dim=2)
    top = shift0(p, -1, 1)
    top = torch.cat([left[:, :1, :], top[:, 1:, :]], dim=1)
    topleft = shift0(left, -1, 1)
    topleft = torch.cat([left[:, :1, :], topleft[:, 1:, :]], dim=1)
    topleft = torch.cat([left[:, :, :1], topleft[:, :, 1:]], dim=2)
    grad = top + left - topleft
    mn = torch.minimum(top, left)
    mx = torch.maximum(top, left)
    guess = torch.where(topleft < mn, mx, torch.where(topleft > mx, mn, grad))
    return gradient_ctx(grad, tables), _pack_signed(p - guess)


def regroup_dc(arr, ygr, xgr, trailing, n_images=1):
    """[G, (C,) t, t] per-group maps -> [Gd, (C,) 8t, 8t] DC-group planes
    (G = ygr*xgr raster groups, ygr/xgr multiples of 8). With n_images=N
    the maps hold N images' groups in turn, and so does the result."""
    gy8, gx8 = ygr // 8, xgr // 8
    t = arr.shape[-1]
    n = n_images
    if trailing:  # [G, C, t, t]
        c = arr.shape[1]
        a = arr.reshape(n, gy8, 8, gx8, 8, c, t, t).permute(0, 1, 3, 5, 2, 6, 4, 7)
        return a.reshape(n * gy8 * gx8, c, 8 * t, 8 * t)
    a = arr.reshape(n, gy8, 8, gx8, 8, t, t).permute(0, 1, 3, 2, 5, 4, 6)
    return a.reshape(n * gy8 * gx8, 8 * t, 8 * t)


def prev_first_scan(first_flat, values_flat, init):
    """prev[i] = values at the last first-cell strictly before i (raster);
    init where none. first_flat: [Gd, N] bool; values_flat: [Gd, N]."""
    n = first_flat.shape[1]
    idx = torch.arange(n, device=first_flat.device).expand_as(first_flat)
    at = torch.where(first_flat, idx, -1)
    at = torch.cat([torch.full_like(at[:, :1], -1), at[:, :-1]], dim=1)
    last = torch.cummax(at, dim=1).values
    got = torch.gather(values_flat, 1, torch.clamp_min(last, 0))
    return torch.where(last >= 0, got, init)


def build_dc_layout(quant_dc, raw_qf, strategy, is_first, ytox, ytob,
                    ydb, xdb, ty, tx, nb_blocks, tables):
    """Per-DC-group section entry layout [Gd, DC_CAP] i32 (u32 patterns).

    quant_dc: [Gd,3,PD,PD] (X,Y,B); raw_qf/strategy/is_first: [Gd,PD,PD];
    ytox/ytob: [Gd,32,32]; ydb/xdb: [Gd] valid block dims; ty/tx: [Gd]
    valid cmap tile dims; nb_blocks: [Gd] ceil_log2(ydb*xdb) bit width."""
    gd = quant_dc.shape[0]
    dev = quant_dc.device
    by = torch.arange(PD, device=dev)[None, :, None]
    bx = torch.arange(PD, device=dev)[None, None, :]
    valid = (by < ydb[:, None, None]) & (bx < xdb[:, None, None])

    def entries(ctx, val, ok):
        w = (ctx.to(torch.int64) << 16) | (val & 0xFFFF)
        return torch.where(ok, w, PAD << 16).reshape(gd, -1)

    parts = [tables.dc_header.expand(gd, 2)]
    # DC tokens, channel order Y, X, B (enc_frame.cc:292).
    for ch in (1, 0, 2):
        ctx, val = gradient_tokens(quant_dc[:, ch], tables)
        parts.append(entries(ctx, val, valid))
    # Mid header: num_ac_blocks-1 in nb_blocks bits, then (4,3).
    num_ac = (is_first & valid).sum(dim=(1, 2))
    mid0 = ((RAW | nb_blocks.to(torch.int64)) << 16) | ((num_ac - 1) & 0xFFFF)
    mid0 = torch.where(nb_blocks > 0, mid0, PAD << 16)
    mid1 = torch.full((gd,), ((RAW | 4) << 16) | 3, device=dev)
    parts.append(torch.stack([mid0, mid1], dim=1))
    # Cmap maps: ytox (ctx 2), ytob (ctx 1), gradient predicted.
    tyv = torch.arange(32, device=dev)[None, :, None]
    txv = torch.arange(32, device=dev)[None, None, :]
    cvalid = (tyv < ty[:, None, None]) & (txv < tx[:, None, None])
    for cm, cc in ((ytox, 2), (ytob, 1)):
        _, val = gradient_tokens(cm, tables)
        parts.append(entries(torch.full_like(val, cc), val, cvalid))
    # AC strategy tokens at first cells; ctx from the previous first cell's
    # code (STRATEGY_CODE = [0, 6, 7]).
    codes = torch.where(strategy == 0, 0, torch.where(strategy == 1, 6, 7)).to(
        torch.int64
    )
    firstv = (is_first & valid).reshape(gd, -1)
    codes_f = codes.reshape(gd, -1)
    prev = prev_first_scan(firstv, codes_f, 0)
    sctx = torch.where(
        prev > 11, 7, torch.where(prev > 5, 8, torch.where(prev > 3, 9, 10))
    )
    fv = firstv.reshape(gd, PD, PD)
    parts.append(entries(sctx.reshape(gd, PD, PD), _pack_signed(codes), fv))
    # Quant field tokens: delta vs the previous first cell's value.
    cur = raw_qf.to(torch.int64).reshape(gd, -1) - 1
    left0 = codes_f[:, :1]  # enc_frame.cc:392: prev seeds from strategy code
    prevq = prev_first_scan(firstv, cur, 0)
    isf_before = torch.cumsum(firstv.to(torch.int64), dim=1) - firstv.to(torch.int64)
    prevq = torch.where(isf_before > 0, prevq, left0)
    qctx = torch.where(
        prevq > 11, 3, torch.where(prevq > 5, 4, torch.where(prevq > 3, 5, 6))
    )
    qval = _pack_signed(cur - prevq)
    parts.append(entries(qctx.reshape(gd, PD, PD), qval.reshape(gd, PD, PD), fv))
    # EPF: one token per valid block, ctx 0, PackSigned(4) == 8.
    z = torch.zeros((gd, PD, PD), dtype=torch.int64, device=dev)
    parts.append(entries(z, z + 8, valid))
    layout = torch.cat(parts, dim=1)
    pad = torch.full((gd, DC_CAP - layout.shape[1]), PAD << 16, device=dev)
    return u32_to_i32(torch.cat([layout, pad], dim=1))


def dc_hist(layout, n_images=1):
    """[Gd, DC_CAP] layout -> [n_images, 64, 64] i64 histograms over DC
    contexts (rows >= 45 stay zero; raw/pad entries excluded), the Gd
    groups being n_images images' DC groups in turn. Counted in rows of
    4096 entries (DC_CAP is a multiple of 4096), so that a frequent bin's
    adds spread over many rows."""
    e = layout.reshape(-1, 4096).to(torch.int64) & 0xFFFFFFFF
    tag = e >> 16
    tok, _, _ = uint_token_extra(e & 0xFFFF)
    h = count_bins(torch.clamp_max(tag, 63) * 64 + tok, tag < 45, 4096, n_images)
    return h.reshape(n_images, 64, 64)


def dc_token_data_bits(layout, d_table):
    """Layout entries -> (data, nbits) int64 for the bit packer. d_table:
    [9, 64] f32, or [Gd, 9, 64] (one table a DC group,
    pack_kernels.table_lookup)."""
    e = layout.to(torch.int64) & 0xFFFFFFFF
    tag = e >> 16
    value = e & 0xFFFF
    is_raw = (tag & RAW) != 0
    is_pad = tag == PAD
    tok, nb_extra, extra = uint_token_extra(value)
    packed = table_lookup(torch.clamp(tag, 0, 63), tok, d_table)
    depth = packed >> 16
    code = packed & 0xFFFF
    data = code | (extra << depth)
    nbits = depth + nb_extra
    data = torch.where(is_raw, value, data)
    nbits = torch.where(is_raw, tag & 0xFF, nbits)
    data = torch.where(is_pad, 0, data)
    nbits = torch.where(is_pad, 0, nbits)
    return data, nbits


def pack_dc_sections(layout, d_table, ow, wcap, compact=True, kernels=True):
    """Program B for the DC sections: layout + code table -> section words
    (the same bit packer and section copy as the AC path)."""
    data, nbits = dc_token_data_bits(layout, d_table)
    ends = torch.cumsum(nbits, dim=1)
    pos = ends - nbits
    bits = ends[:, -1]
    packed = bitpack_groups_words(data, nbits, pos, ow, prefix_valid=False,
                                  kernels=kernels)
    if not compact:
        return dict(words=packed, bits=bits, word_offs=torch.zeros_like(bits))
    words, offs = compact_sections(packed, bits, wcap, kernels)
    return dict(words=words, bits=bits, word_offs=offs)


def select_code_table(hist64, depths_k):
    """Pick the cheapest candidate code table on the device.

    hist64: [64, 64] i64 token histogram, or [N, 64, 64] (one pick an
    image); depths_k: [K, 64, 64] i32 per-candidate (ctx, token) ->
    emission depth grids. The cost is an exact int64 sum (the JAX package
    splits it into two int32 partial sums to the same end), so the argmin
    is deterministic; ties go to the lowest index. Returns a 0-d (or [N])
    int64 tensor."""
    cost = (hist64.to(torch.int64)[..., None, :, :] * depths_k.to(torch.int64)).sum(
        dim=(-2, -1)
    )
    return torch.argmin(cost, dim=-1)  # the first minimum, as jnp.argmin


def per_group_tables(d, groups_per_image):
    """[N, 9, 64] per-image code tables -> [N * groups_per_image, 9, 64],
    each image's table repeated for its groups (expand, not
    repeat_interleave, whose output size may be read on the host)."""
    n = d.shape[0]
    return d[:, None].expand(n, groups_per_image, *d.shape[1:]).reshape(
        n * groups_per_image, *d.shape[1:]
    )


def pack_batch_sections(stream, totals, d_ac, layout, d_dc, ow_ac, wcap_ac,
                        ow_dc, wcap_dc, compact_ac=True, compact_dc=True,
                        kernels=True):
    """Program B: the AC and DC sections of N images (one image: N = 1) in
    one pass over their N*G groups and N*Gd DC groups. d_ac / d_dc:
    per-image factored tables [N, 9, 64]; stream holds N*G groups, layout
    N*Gd DC groups, each image's in turn. All sections land in the two
    shared word buffers; `small` holds the four small vectors [ac_bits,
    ac_offs, dc_bits, dc_offs] for one device->host copy."""
    n = d_ac.shape[0]
    ac = pack_ac_sections(stream, totals, per_group_tables(d_ac, stream.shape[0] // n),
                          ow_ac, wcap_ac, compact_ac, kernels)
    dc = pack_dc_sections(layout, per_group_tables(d_dc, layout.shape[0] // n),
                          ow_dc, wcap_dc, compact_dc, kernels)
    return dict(
        ac_words=ac["words"], ac_bits=ac["bits"], ac_offs=ac["word_offs"],
        dc_words=dc["words"], dc_bits=dc["bits"], dc_offs=dc["word_offs"],
        small=torch.cat([ac["bits"], ac["word_offs"], dc["bits"], dc["word_offs"]]),
    )


def analyze_pack_batch_static(images, yb_valid, xb_valid, d_ac, d_dc,
                              ac_depths, dc_depths, distp, cap, tables, cfl,
                              blocks, ow_ac, wcap_ac, ow_dc, wcap_dc,
                              compact_ac=True, compact_dc=True, kernels=True):
    """One-pass tier: analysis + section packing of N same-sized images
    (one image: N = 1) with static code tables, with no histogram round
    trip to the host in between (the reference's OPTIMIZE_CODE=0 design).
    d_ac / d_dc hold K candidate tables [K, 9, 64] each; the device picks
    each image's cheapest from its own histograms (select_code_table) and
    reports the picks at the end of `small`, so that the host serializes
    the same tables into ACGlobal / DCGlobal. `small` layout: [ac_bits,
    ac_offs, dc_bits, dc_offs, totals, k_ac[N], k_dc[N]]."""
    from .pipeline import analyze_batch_packed

    a = analyze_batch_packed(
        images, yb_valid, xb_valid, distp, cap, tables, cfl, blocks, kernels
    )
    k_ac = select_code_table(a["hists"][:, 0], ac_depths)
    k_dc = select_code_table(a["hists"][:, 1], dc_depths)
    b = pack_batch_sections(
        a["stream"][:, :cap].contiguous(), a["totals"], d_ac.index_select(0, k_ac),
        a["dc_layout"], d_dc.index_select(0, k_dc), ow_ac=ow_ac,
        wcap_ac=wcap_ac, ow_dc=ow_dc, wcap_dc=wcap_dc, compact_ac=compact_ac,
        compact_dc=compact_dc, kernels=kernels,
    )
    b["totals"] = a["totals"]
    b["small"] = torch.cat([b["small"], a["totals"], k_ac, k_dc])
    return b


def dc_group_geometry(ysize, xsize):
    """Per-DC-group valid dims (enc_frame.cc:48-93): lists ydb, xdb (blocks),
    ty, tx (cmap tiles) and nb (ceil_log2 of the block count)."""
    ydg, xdg = div_ceil(ysize, 2048), div_ceil(xsize, 2048)
    geo = dict(ydb=[], xdb=[], ty=[], tx=[], nb=[])
    for dy in range(ydg):
        for dx in range(xdg):
            ydb = div_ceil(min(2048, ysize - dy * 2048), 8)
            xdb = div_ceil(min(2048, xsize - dx * 2048), 8)
            geo["ydb"].append(ydb)
            geo["xdb"].append(xdb)
            geo["ty"].append(div_ceil(ydb * 8, 64))
            geo["tx"].append(div_ceil(xdb * 8, 64))
            geo["nb"].append(int(ydb * xdb - 1).bit_length())
    return geo
