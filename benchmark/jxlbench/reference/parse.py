"""Parse a codestream back into the quantized image it encodes.

Frozen copy of the port's verification decoder,
jxl_tiny_tpu_torch/decode/decoder.py at commit 8ebce9c, cut to its parsing
half: the header, TOC, DC global, DC groups, AC global and AC groups are
read with the same strictness (every section's bit count against its TOC
size, zero padding, the fixed modular tree, value ranges), and what comes
out is what the encoder decided, not pixels: the quantized DC, the raw
quant field, the block strategies, the colour-correlation maps and every
quantized AC coefficient. Dequantization, the IDCTs and the filters are left
out: the benchmark compares these integers with the golden model's.

The sections parse in three steps so that a pool of processes can share
the work: `parse_front` (header, TOC, DC global, AC global), then
`parse_dc_group` for each DC group and `parse_ac_group` for each group,
which need only what `parse_front` returned (the AC groups also the DC
groups' maps, merged by `merge_dc`).
"""
import dataclasses

import numpy as np

from . import constants as C
from .bit_reader import BitReader
from .common import ImageDim, div_ceil
from .errors import DecodeError
from .huffman_read import TokenReader, read_context_map, read_histograms


def strict(fn):
    """Any defect the parse trips over surfaces as DecodeError, as the
    port's decode_jxl converts its internal failures."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except DecodeError:
            raise
        except (AssertionError, IndexError, ValueError, KeyError, OverflowError) as e:
            raise DecodeError(f"malformed codestream: {type(e).__name__}: {e}") from e

    return wrapper


def unpack_signed(u):
    return (u >> 1) ^ -(u & 1)


def _expect(reader, nbits, value, what):
    got = reader.read(nbits)
    if got != value:
        raise DecodeError(f"{what}: expected {value}, got {got}")


def _read_size(reader):
    k_bits = (9, 13, 18, 30)
    sel = reader.read(2)
    return reader.read(k_bits[sel]) + 1


@dataclasses.dataclass
class Front:
    """What every later section needs: the geometry, the quant scales, the
    DC and AC codes, and each section's bytes; and the loop filters the
    frame header asks of a decoder."""
    dim: ImageDim
    x_qm_scale: int
    global_scale: int
    quant_dc_param: int
    gaborish: bool
    epf_iters: int
    dc_codes: tuple
    ac_codes: tuple
    dc_sections: list
    ac_sections: list


@dataclasses.dataclass
class Maps:
    """The image's maps: quant_dc [3, yb, xb] (X, Y, B), raw_qf, strategy,
    is_first [yb, xb], ytox, ytob [ty, tx]."""
    quant_dc: np.ndarray
    raw_qf: np.ndarray
    strategy: np.ndarray
    is_first: np.ndarray
    ytox: np.ndarray
    ytob: np.ndarray


def _end_section(rr):
    # Sections are whole bytes with zero fill bits and an exact TOC size.
    rr.zero_pad_to_byte()
    if rr.bits_remaining() != 0:
        raise DecodeError(f"section has {rr.bits_remaining() // 8} trailing bytes")


@strict
def parse_front(data: bytes) -> Front:
    """Header, TOC, DC global and AC global; raises DecodeError on any
    defect. A stream whose TOC is collapsed into one entry (an image of one
    group) is refused: no configuration of the benchmark makes one."""
    r = BitReader(data)
    _expect(r, 8, 0xFF, "signature")
    _expect(r, 8, 0x0A, "marker")
    _expect(r, 1, 0, "small")
    ysize = _read_size(r)
    _expect(r, 3, 0, "ratio")
    xsize = _read_size(r)
    # ImageMetadata (fixed layout, enc_file.cc:75-94).
    for nbits, value, what in (
        (1, 0, "all_default"), (1, 0, "extra_fields"), (1, 1, "float_samples"),
        (2, 0, "bits"), (4, 7, "exp_bits"), (1, 0, "mod16"), (2, 0, "extra_channels"),
        (1, 1, "xyb"), (1, 0, "color_all_default"), (1, 0, "icc"), (2, 0, "color_space"),
        (2, 1, "white_point"), (2, 1, "primaries"), (1, 0, "gamma"), (2, 2, "tf_selector"),
        (4, 6, "tf"), (2, 1, "intent"), (2, 0, "extensions"), (1, 1, "default_transform"),
    ):
        _expect(r, nbits, value, what)
    r.zero_pad_to_byte()

    # FrameHeader (enc_frame.cc:426-457).
    _expect(r, 1, 0, "frame all_default")
    _expect(r, 2, 0, "frame type")
    _expect(r, 1, 0, "vardct")
    _expect(r, 2, 2, "flags selector")
    _expect(r, 8, 111, "flags")
    _expect(r, 2, 0, "upsampling")
    x_qm_scale = r.read(3)
    _expect(r, 3, 2, "b_qm_scale")
    _expect(r, 2, 0, "passes")
    _expect(r, 1, 0, "custom size")
    _expect(r, 2, 0, "blend")
    _expect(r, 1, 1, "last frame")
    _expect(r, 2, 0, "name")
    if r.read(1) == 1:
        # All-default loop filter: gaborish on and 2 EPF iterations.
        gaborish, epf_iters = True, 2
    else:
        _expect(r, 1, 0, "gaborish")
        gaborish = False
        epf_iters = r.read(2)
        if epf_iters > 0:
            _expect(r, 1, 0, "epf sharpness")
            _expect(r, 1, 0, "epf weights")
            _expect(r, 1, 0, "epf sigma")
        _expect(r, 2, 0, "lf extensions")
    _expect(r, 2, 0, "frame extensions")

    dim = ImageDim(xsize, ysize)
    num_sections = 2 + dim.num_dc_groups + dim.num_groups
    if num_sections == 4:
        raise DecodeError("a collapsed TOC (one group) is not parsed here")

    # TOC (enc_frame.cc:572-595).
    _expect(r, 1, 0, "toc permutation")
    r.zero_pad_to_byte()
    sizes = []
    for _ in range(num_sections):
        sel = r.read(2)
        nb = (10, 14, 22, 30)[sel]
        offset = sum((1 << (10, 14, 22, 30)[i]) for i in range(sel))
        sizes.append(r.read(nb) + offset)
    r.zero_pad_to_byte()
    base = r.pos // 8
    offsets = np.cumsum([0] + sizes)
    if base + int(offsets[-1]) != len(data):
        raise DecodeError(f"file size {len(data)} does not match TOC "
                          f"({base} header + {int(offsets[-1])} section bytes)")
    payload = data[base:]
    sections = [payload[offsets[i]: offsets[i + 1]] for i in range(num_sections)]

    rr = BitReader(sections[0])
    global_scale, quant_dc_param, dc_codes = _parse_dc_global(rr, dim.num_dc_groups)
    _end_section(rr)
    rr = BitReader(sections[1 + dim.num_dc_groups])
    ac_codes = _parse_ac_global(rr, dim.num_groups)
    _end_section(rr)
    return Front(dim, x_qm_scale, global_scale, quant_dc_param, gaborish, epf_iters,
                 dc_codes, ac_codes,
                 sections[1: 1 + dim.num_dc_groups], sections[2 + dim.num_dc_groups:])


def _parse_dc_global(r, num_dc_groups):
    _expect(r, 1, 1, "default dequant dc")
    # Quant scales (enc_frame.cc:459-485).
    sel = r.read(2)
    global_scale = r.read((11, 11, 12, 16)[sel]) + (1, 2049, 4097, 8193)[sel]
    sel = r.read(2)
    quant_dc_param = 16 if sel == 0 else r.read((0, 5, 8, 16)[sel]) + 1
    # BlockCtxMap (must be the compact map).
    _expect(r, 1, 0, "blockctx not default")
    _expect(r, 16, 0, "no dc/qf thresholds")
    cm, _ = read_context_map(r, 39)
    if not (cm == C.COMPACT_BLOCK_CTX_MAP).all():
        raise DecodeError("unexpected block context map")
    _expect(r, 1, 1, "default dc cmap")
    # Global modular tree: it must be the fixed gradient tree.
    _expect(r, 1, 1, "tree not empty")
    tree_cm, tree_dec = read_histograms(r, C.NUM_TREE_CONTEXTS)
    _parse_tree(TokenReader(r, tree_cm, tree_dec), num_dc_groups)
    return global_scale, quant_dc_param, read_histograms(r, C.NUM_DC_CONTEXTS)


def _parse_tree(ttok, num_dc_groups):
    """The modular MA tree must be the fixed gradient tree of the tiny
    format (enc_frame.cc:487-502) with the DC-group count patched in."""
    expected = C.CONTEXT_TREE_TOKENS
    exp_rows = expected.shape[0]
    patched_val = 2 * (1 + num_dc_groups)  # pack_signed of a positive value
    got = 0

    def check(ctx, val):
        nonlocal got
        if got >= exp_rows:
            raise DecodeError("modular tree larger than the fixed tree")
        ectx, eval_ = int(expected[got, 0]), int(expected[got, 1])
        if got == 1:
            eval_ = patched_val
        if (ctx, val) != (ectx, eval_):
            raise DecodeError(f"modular tree deviates from the fixed tree at token {got}: "
                              f"got ({ctx},{val}), expected ({ectx},{eval_})")
        got += 1

    nodes_left = 1
    while nodes_left:
        nodes_left -= 1
        prop = ttok.read(1)
        check(1, prop)
        if prop == 0:
            check(2, ttok.read(2))  # predictor
            check(3, ttok.read(3))  # offset
            check(4, ttok.read(4))  # multiplier log
            check(5, ttok.read(5))  # multiplier bits
        else:
            check(0, ttok.read(0))  # split value
            nodes_left += 2
    if got != exp_rows:
        raise DecodeError("modular tree smaller than the fixed tree")


def _parse_ac_global(r, num_groups):
    _expect(r, 1, 1, "default quant matrices")
    nb = (num_groups - 1).bit_length()
    if nb:
        _expect(r, nb, 0, "num histograms")
    _expect(r, 2, 3, "coeff order selector")
    _expect(r, 13, 0, "coeff orders")
    return read_histograms(r, C.NUM_AC_CONTEXTS)


@strict
def parse_dc_group(front: Front, idx: int):
    """DC group idx -> (by0, bx0, quant_dc [3, ydb, xdb], raw_qf, strategy,
    is_first [ydb, xdb], ytox, ytob [ty, tx])."""
    dim = front.dim
    r = BitReader(front.dc_sections[idx])
    dgy, dgx = divmod(idx, dim.xsize_dc_groups)
    by0, bx0 = dgy * 256, dgx * 256
    ydb = min(256, dim.ysize_blocks - by0)
    xdb = min(256, dim.xsize_blocks - bx0)
    tok = TokenReader(r, *front.dc_codes)
    _expect(r, 2, 0, "extra dc precision")
    _expect(r, 4, 3, "dc modular header")
    quant_dc = np.zeros((3, ydb, xdb), np.int32)
    for c in (1, 0, 2):  # DC planes, channel order Y, X, B
        quant_dc[c] = _parse_gradient_plane(tok, ydb, xdb)
    # AC metadata.
    num_blocks = ydb * xdb
    nb = (num_blocks - 1).bit_length()
    num_ac_blocks = r.read(nb) + 1 if nb else 1
    _expect(r, 4, 3, "acmeta modular header")
    ty, tx = div_ceil(ydb * 8, 64), div_ceil(xdb * 8, 64)
    ytox = _parse_gradient_plane(tok, ty, tx, ctx_override=2)
    ytob = _parse_gradient_plane(tok, ty, tx, ctx_override=1)
    # Strategy tokens.
    strat = np.zeros((ydb, xdb), np.uint8)
    first = np.zeros((ydb, xdb), bool)
    occupied = np.zeros((ydb, xdb), bool)
    positions = []
    left = 0
    for by in range(ydb):
        for bx in range(xdb):
            if occupied[by, bx]:
                continue
            ctx = 7 if left > 11 else 8 if left > 5 else 9 if left > 3 else 10
            code = unpack_signed(tok.read(ctx))
            if code not in (0, 6, 7):
                raise DecodeError(f"strategy code {code} outside the tiny subset")
            typ = {0: C.DCT8, 6: C.DCT16X8, 7: C.DCT8X16}[code]
            cy, cx = int(C.COVERED_Y[typ]), int(C.COVERED_X[typ])
            if by + cy > ydb or bx + cx > xdb or occupied[by: by + cy, bx: bx + cx].any():
                raise DecodeError(f"transform at block ({by}, {bx}) overlaps or leaves "
                                  "the DC group")
            strat[by: by + cy, bx: bx + cx] = typ
            occupied[by: by + cy, bx: bx + cx] = True
            first[by, bx] = True
            positions.append((by, bx))
            left = code
    if len(positions) != num_ac_blocks:
        raise DecodeError(f"{len(positions)} transforms, header says {num_ac_blocks}")
    # Quant field tokens.
    qf = np.ones((ydb, xdb), np.int32)
    left = int(C.STRATEGY_CODE[strat[0, 0]])
    for by, bx in positions:
        ctx = 3 if left > 11 else 4 if left > 5 else 5 if left > 3 else 6
        cur = left + unpack_signed(tok.read(ctx))
        if not 0 <= cur <= 254:
            raise DecodeError(f"quant field value {cur + 1} out of range")
        typ = strat[by, bx]
        cy, cx = int(C.COVERED_Y[typ]), int(C.COVERED_X[typ])
        qf[by: by + cy, bx: bx + cx] = cur + 1
        left = cur
    # EPF tokens.
    for _ in range(num_blocks):
        if unpack_signed(tok.read(0)) != 4:
            raise DecodeError("unexpected EPF sharpness")
    _end_section(r)
    return by0, bx0, quant_dc, qf, strat, first, ytox, ytob


def _parse_gradient_plane(tok, h, w, ctx_override=None):
    p = [[0] * w for _ in range(h)]
    lut = C.GRADIENT_CTX_LUT.tolist()
    for y in range(h):
        row, up = p[y], p[y - 1] if y else None
        for x in range(w):
            left = row[x - 1] if x else (up[x] if y else 0)
            top = up[x] if y else left
            topleft = up[x - 1] if (x and y) else left
            grad = top + left - topleft
            mn, mx = min(top, left), max(top, left)
            guess = mx if topleft < mn else mn if topleft > mx else grad
            ctx = lut[min(max(512 + grad, 0), 1023)] if ctx_override is None else ctx_override
            row[x] = guess + unpack_signed(tok.read(ctx))
    return np.array(p, np.int64).reshape(h, w)


def merge_dc(front: Front, parts) -> Maps:
    """The DC groups' parse_dc_group results -> the image's Maps."""
    dim = front.dim
    yb, xb = dim.ysize_blocks, dim.xsize_blocks
    ty, tx = div_ceil(dim.ysize, 64), div_ceil(dim.xsize, 64)
    m = Maps(np.zeros((3, yb, xb), np.int32), np.ones((yb, xb), np.int32),
             np.zeros((yb, xb), np.uint8), np.ones((yb, xb), bool),
             np.zeros((ty, tx), np.int32), np.zeros((ty, tx), np.int32))
    for by0, bx0, qdc, qf, strat, first, ytox, ytob in parts:
        ydb, xdb = qf.shape
        m.quant_dc[:, by0: by0 + ydb, bx0: bx0 + xdb] = qdc
        m.raw_qf[by0: by0 + ydb, bx0: bx0 + xdb] = qf
        m.strategy[by0: by0 + ydb, bx0: bx0 + xdb] = strat
        m.is_first[by0: by0 + ydb, bx0: bx0 + xdb] = first
        t0y, t0x = by0 // 8, bx0 // 8
        m.ytox[t0y: t0y + ytox.shape[0], t0x: t0x + ytox.shape[1]] = ytox
        m.ytob[t0y: t0y + ytob.shape[0], t0x: t0x + ytob.shape[1]] = ytob
    return m


@strict
def parse_ac_group(ac_codes, section: bytes, strategy, is_first) -> np.ndarray:
    """One AC group's section -> its quantized coefficients [3 (X, Y, B),
    32, 32, 128] int32 in the golden model's layout: at each first cell of
    a transform, the coefficient at position order[k] (k >= the cells
    covered; the lowest frequencies come from the DC), zero elsewhere and
    past the image. strategy, is_first: the group's [yb, xb] maps."""
    r = BitReader(section)
    yb, xb = strategy.shape
    tok = TokenReader(r, *ac_codes)
    out = np.zeros((3, 32, 32, 128), np.int32)
    nz_map = np.zeros((3, 32, 32), np.int64)
    orders = {C.DCT8: C.COEFF_ORDER8.tolist(), C.DCT16X8: C.COEFF_ORDER16.tolist(),
              C.DCT8X16: C.COEFF_ORDER16.tolist()}
    nnz_ctx, freq_ctx = C.COEFF_NNZ_CTX.tolist(), C.COEFF_FREQ_CTX.tolist()
    for by in range(yb):
        for bx in range(xb):
            if not is_first[by, bx]:
                continue
            typ = int(strategy[by, bx])
            cbx, cby = int(C.COVERED_X[typ]), int(C.COVERED_Y[typ])
            covered = cbx * cby
            size = covered * 64
            order = orders[typ]
            strat_code = int(C.STRATEGY_CODE[typ])
            for c in (1, 0, 2):
                block_ctx = int(C.BLOCK_CTX_MAP[c, strat_code])
                # Predicted nzeros (enc_group.cc:150-160).
                if by == 0 and bx == 0:
                    pred = 32
                elif by == 0:
                    pred = nz_map[c, by, bx - 1]
                elif bx == 0:
                    pred = nz_map[c, by - 1, bx]
                else:
                    pred = (nz_map[c, by - 1, bx] + nz_map[c, by, bx - 1] + 1) // 2
                pred = int(pred)
                bucket = pred if pred < 8 else 36 if pred >= 64 else 4 + pred // 2
                nzeros = tok.read(bucket * C.NUM_BLOCK_CTXS + block_ctx)
                if nzeros > size - covered:
                    raise DecodeError(f"{nzeros} nonzeros in a {size}-coefficient block")
                nz_map[c, by: by + cby, bx: bx + cbx] = -(-nzeros // covered)
                zd_off = (C.NUM_BLOCK_CTXS * C.NONZERO_BUCKETS
                          + C.ZERO_DENSITY_CONTEXT_COUNT * block_ctx)
                prev = 0 if nzeros > (size >> 4) else 1
                nleft = nzeros
                k = covered
                row = out[c, by, bx]
                while k < size and nleft:
                    nl_s = -(-nleft // covered)
                    ctx = zd_off + (nnz_ctx[nl_s] + freq_ctx[k >> (covered - 1)]) * 2 + prev
                    coeff = unpack_signed(tok.read(ctx))
                    row[order[k]] = coeff
                    prev = 1 if coeff else 0
                    nleft -= prev
                    k += 1
                if nleft:
                    raise DecodeError("nonzeros left at the end of a block")
    _end_section(r)
    return out
