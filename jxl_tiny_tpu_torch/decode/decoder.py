"""Verification decoder for the tiny VarDCT subset (numpy, on the host; a
copy of the JAX package's decode/decoder.py).

Decodes codestreams produced by this package *and* by the reference cjxl_tiny
(same header layout, fixed modular tree, prefix codes). Restoration filters
(EPF / gaborish) are NOT applied; output is the pre-filter reconstruction,
which is what PSNR comparisons in the tests use.

Not a general JPEG XL decoder: asserts on the fixed field values the tiny
encoder emits.
"""
import numpy as np

from .. import constants as C
from ..common import ImageDim, div_ceil
from ..errors import DecodeError
from ..bitstream.bit_reader import BitReader
from ..ref.dct_np import idct2d_blocks
from .huffman_read import read_histograms, TokenReader


def unpack_signed(u):
    u = int(u)
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)


def _expect(reader, nbits, value, what):
    v = reader.read(nbits)
    if v != value:
        raise DecodeError(f"{what}: expected {value}, got {v}")


def _read_size(reader):
    k_bits = (9, 13, 18, 30)
    sel = reader.read(2)
    return reader.read(k_bits[sel]) + 1


def decode_jxl(data: bytes, return_xyb=False, filters=False, crop=True):
    """filters=False returns the pre-filter reconstruction (the historical
    behavior every byte-level test uses). filters=True applies the
    restoration chain the frame header signals — gaborish + EPF exactly as
    stock djxl would render it (decode.filters) — before the color
    transform.

    Strict: any malformed input surfaces as errors.DecodeError — bit-level
    over/under-reads per section, nonzero padding, TOC/file-size
    mismatches, and out-of-range field or symbol values (internal
    assertion/index failures are converted; tests/test_fuzz_decode.py
    drives this with mutation corpora).

    crop=False returns the full 8-multiple block grid instead of the
    image rectangle (fuzz tests compare pad blocks too — they are coded
    bits even though rendering crops them)."""
    try:
        return _decode_jxl_impl(data, return_xyb, filters, crop)
    except DecodeError:
        raise
    except (AssertionError, IndexError, ValueError, KeyError, OverflowError) as e:
        raise DecodeError(f"malformed codestream: {type(e).__name__}: {e}") from e


def section_spans(data: bytes):
    """Byte spans of each codestream section, by decoding `data`:
    [(name, start, end)] with names 'header', 'dc_global', 'dc_group',
    'ac_global', 'ac_group'. For collapsed-TOC streams (num_sections == 4,
    enc_frame.cc:572-595) sections share bytes at the seams (bit-level
    concatenation) so spans are rounded outward to whole bytes and may
    overlap by one. Used by the fuzz tests to mask the known-inert table
    regions (unused prefix-code depths / cluster ids live only in the
    global sections) when tightening silent-identity bounds."""
    spans = []
    _decode_jxl_impl(data, return_xyb=True, filters=False, crop=False,
                     spans=spans)
    return spans


def _decode_jxl_impl(data: bytes, return_xyb, filters, crop, spans=None):
    r = BitReader(data)
    _expect(r, 8, 0xFF, "signature")
    _expect(r, 8, 0x0A, "marker")
    _expect(r, 1, 0, "small")
    ysize = _read_size(r)
    _expect(r, 3, 0, "ratio")
    xsize = _read_size(r)
    # ImageMetadata (fixed layout, enc_file.cc:75-94).
    for nbits, value, what in (
        (1, 0, "all_default"),
        (1, 0, "extra_fields"),
        (1, 1, "float_samples"),
        (2, 0, "bits"),
        (4, 7, "exp_bits"),
        (1, 0, "mod16"),
        (2, 0, "extra_channels"),
        (1, 1, "xyb"),
        (1, 0, "color_all_default"),
        (1, 0, "icc"),
        (2, 0, "color_space"),
        (2, 1, "white_point"),
        (2, 1, "primaries"),
        (1, 0, "gamma"),
        (2, 2, "tf_selector"),
        (4, 6, "tf"),
        (2, 1, "intent"),
        (2, 0, "extensions"),
        (1, 1, "default_transform"),
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
        # All-default loop filter: gaborish ON + 2 EPF iterations.
        gab, epf_iters = True, 2
    else:
        _expect(r, 1, 0, "gaborish")
        gab = False
        epf_iters = r.read(2)
        if epf_iters > 0:
            _expect(r, 1, 0, "epf sharpness")
            _expect(r, 1, 0, "epf weights")
            _expect(r, 1, 0, "epf sigma")
        _expect(r, 2, 0, "lf extensions")
    _expect(r, 2, 0, "frame extensions")

    dim = ImageDim(xsize, ysize)
    num_sections = 2 + dim.num_dc_groups + dim.num_groups

    # TOC (enc_frame.cc:572-595).
    _expect(r, 1, 0, "toc permutation")
    r.zero_pad_to_byte()
    n_toc = 1 if num_sections == 4 else num_sections
    sizes = []
    for _ in range(n_toc):
        sel = r.read(2)
        nb = (10, 14, 22, 30)[sel]
        offset = sum((1 << (10, 14, 22, 30)[i]) for i in range(sel))
        sizes.append(r.read(nb) + offset)
    r.zero_pad_to_byte()

    base = r.pos // 8
    offsets = np.cumsum([0] + sizes)
    payload = data[base:]
    if base + int(offsets[-1]) != len(data):
        raise DecodeError(
            f"file size {len(data)} does not match TOC "
            f"({base} header + {int(offsets[-1])} section bytes)"
        )
    if n_toc == 1:
        # All sections concatenated in one; parse sequentially from one reader.
        section_readers = [BitReader(payload[: sizes[0]])] * num_sections
        sequential = True
    else:
        section_readers = [
            BitReader(payload[offsets[i] : offsets[i + 1]]) for i in range(n_toc)
        ]
        sequential = False

    def end_section(rr):
        # Sections are whole bytes with zero fill bits and an exact TOC
        # size — trailing bytes would make djxl's section accounting fail.
        # Collapsed (single-TOC-entry) sections are concatenated at the BIT
        # level with no padding between them (BitWriter::Append,
        # enc_bit_writer.cc:90-108), so only the combined section ends on a
        # padded byte.
        if sequential:
            return
        rr.zero_pad_to_byte()
        if rr.bits_remaining() != 0:
            raise DecodeError(
                f"section has {rr.bits_remaining() // 8} trailing bytes"
            )

    state = _DecoderState(dim, x_qm_scale)

    if spans is not None:
        spans.append(("header", 0, base))

    def span(name, rr, k, fn, *args):
        if spans is None or not sequential:
            if spans is not None:
                spans.append(
                    ("", int(base + offsets[k]), int(base + offsets[k + 1]))
                )
            fn(rr, *args)
            if spans is not None:
                spans[-1] = (name,) + spans[-1][1:]
            return
        start = rr.pos
        fn(rr, *args)
        spans.append((name, base + start // 8, base + -(-rr.pos // 8)))

    # Section order: DCGlobal, DCGroups..., ACGlobal, ACGroups...
    sr = section_readers[0]
    span("dc_global", sr, 0, _decode_dc_global, state)
    end_section(sr if sequential else section_readers[0])
    for i in range(dim.num_dc_groups):
        rr = sr if sequential else section_readers[1 + i]
        span("dc_group", rr, 1 + i, _decode_dc_group, state, i)
        end_section(rr)
    rr = sr if sequential else section_readers[1 + dim.num_dc_groups]
    span("ac_global", rr, 1 + dim.num_dc_groups, _decode_ac_global, state)
    end_section(rr)
    for i in range(dim.num_groups):
        rr = sr if sequential else section_readers[2 + dim.num_dc_groups + i]
        span("ac_group", rr, 2 + dim.num_dc_groups + i, _decode_ac_group,
             state, i)
        end_section(rr)
    if sequential:
        sr.zero_pad_to_byte()
        if sr.bits_remaining() != 0:
            raise DecodeError(
                f"collapsed section has {sr.bits_remaining() // 8} "
                "trailing bytes"
            )

    xyb = state.finish_pixels()
    if filters and (gab or epf_iters > 0):
        from .filters import apply_restoration_filters

        xyb = apply_restoration_filters(
            xyb, state.raw_qf, state.scale, epf_iters, gab
        )
    if not crop:
        ysize, xsize = xyb.shape[1], xyb.shape[2]
    if return_xyb:
        return xyb[:, :ysize, :xsize]
    rgb = xyb_to_linear(xyb)[:, :ysize, :xsize]
    return rgb


class _DecoderState:
    def __init__(self, dim: ImageDim, x_qm_scale):
        self.dim = dim
        self.x_qm_scale = x_qm_scale
        self.x_qm_mul = float(np.float32(1.25) ** np.float32(x_qm_scale - 2.0))
        yb = dim.ysize_blocks
        xb = dim.xsize_blocks
        self.quant_dc = np.zeros((3, yb, xb), np.int32)
        self.raw_qf = np.ones((yb, xb), np.int32)
        self.strategy = np.zeros((yb, xb), np.uint8)
        self.is_first = np.ones((yb, xb), bool)
        ty, tx = div_ceil(dim.ysize, 64), div_ceil(dim.xsize, 64)
        self.ytox = np.zeros((ty, tx), np.int32)
        self.ytob = np.zeros((ty, tx), np.int32)
        self.global_scale = None
        self.quant_dc_param = None
        self.dc_tokens = None
        self.ac_tokens = None
        # Reconstructed coefficients per block cell [3, yb, xb, 8, 8]-ish:
        # store per-cell 8x8 coefficient planes after IDCT assembly instead.
        self.pixels = np.zeros((3, yb * 8, xb * 8), np.float32)
        self.nzeros_map = np.zeros((3, 32, 32), np.int32)  # per group, reset

    @property
    def scale(self):
        return self.global_scale / 65536.0

    @property
    def scale_dc(self):
        return self.quant_dc_param * self.scale

    def finish_pixels(self):
        return self.pixels


def _decode_dc_global(r, state):
    _expect(r, 1, 1, "default dequant dc")
    # Quant scales (enc_frame.cc:459-485).
    sel = r.read(2)
    if sel == 0:
        state.global_scale = r.read(11) + 1
    elif sel == 1:
        state.global_scale = r.read(11) + 2049
    elif sel == 2:
        state.global_scale = r.read(12) + 4097
    else:
        state.global_scale = r.read(16) + 8193
    sel = r.read(2)
    if sel == 0:
        state.quant_dc_param = 16
    elif sel == 1:
        state.quant_dc_param = r.read(5) + 1
    elif sel == 2:
        state.quant_dc_param = r.read(8) + 1
    else:
        state.quant_dc_param = r.read(16) + 1
    # BlockCtxMap (must be the compact map).
    _expect(r, 1, 0, "blockctx not default")
    _expect(r, 16, 0, "no dc/qf thresholds")
    from .huffman_read import read_context_map

    cm, _ = read_context_map(r, 39)
    assert (cm == C.COMPACT_BLOCK_CTX_MAP).all(), "unexpected block context map"
    _expect(r, 1, 1, "default dc cmap")
    # Global modular tree: parse and discard (fixed tree).
    _expect(r, 1, 1, "tree not empty")
    tree_cm, tree_dec = read_histograms(r, C.NUM_TREE_CONTEXTS)
    ttok = TokenReader(r, tree_cm, tree_dec)
    _parse_tree(ttok, state.dim.num_dc_groups)
    # DC token histograms.
    dc_cm, dc_dec = read_histograms(r, C.NUM_DC_CONTEXTS)
    state.dc_tokens = (dc_cm, dc_dec)


def _parse_tree(ttok, num_dc_groups):
    """Parse the modular MA tree and verify it IS the fixed gradient tree
    of the tiny format (enc_frame.cc:487-502, constants.CONTEXT_TREE_TOKENS
    with the DC-group count patched in). The tree is load-bearing for
    djxl's modular decoding even though this decoder's DC path hardcodes
    its semantics — silently skipping it would accept streams djxl decodes
    differently."""
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
            raise DecodeError(
                f"modular tree deviates from the fixed tree at token {got}: "
                f"got ({ctx},{val}), expected ({ectx},{eval_})"
            )
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


def _decode_dc_group(r, state, idx):
    dim = state.dim
    dgy, dgx = divmod(idx, dim.xsize_dc_groups)
    by0, bx0 = dgy * 256, dgx * 256
    ydb = min(256, dim.ysize_blocks - by0)
    xdb = min(256, dim.xsize_blocks - bx0)
    cm, dec = state.dc_tokens
    tok = TokenReader(r, cm, dec)
    _expect(r, 2, 0, "extra dc precision")
    _expect(r, 4, 3, "dc modular header")
    # DC planes, channel order Y, X, B.
    for c in (1, 0, 2):
        plane = _decode_gradient_plane(tok, ydb, xdb)
        state.quant_dc[c, by0 : by0 + ydb, bx0 : bx0 + xdb] = plane
    # AC metadata.
    num_blocks = ydb * xdb
    nb = (num_blocks - 1).bit_length()
    if nb:
        num_ac_blocks = r.read(nb) + 1
    else:
        num_ac_blocks = 1
    _expect(r, 4, 3, "acmeta modular header")
    ty, tx = div_ceil(ydb * 8, 64), div_ceil(xdb * 8, 64)
    for c, target in ((0, state.ytox), (1, state.ytob)):
        plane = _decode_gradient_plane(tok, ty, tx, ctx_override=2 - c)
        target[dgy * 32 : dgy * 32 + ty, dgx * 32 : dgx * 32 + tx] = plane
    # Strategy tokens.
    strat_sb = np.zeros((ydb, xdb), np.uint8)
    first_sb = np.zeros((ydb, xdb), bool)
    left = 0
    decoded = 0
    by = bx = 0
    occupied = np.zeros((ydb, xdb), bool)
    positions = []
    for by in range(ydb):
        for bx in range(xdb):
            if occupied[by, bx]:
                continue
            ctx = 7 if left > 11 else 8 if left > 5 else 9 if left > 3 else 10
            code = unpack_signed(tok.read(ctx))
            typ = {0: C.DCT8, 6: C.DCT16X8, 7: C.DCT8X16}[code]
            cy, cx = int(C.COVERED_Y[typ]), int(C.COVERED_X[typ])
            strat_sb[by : by + cy, bx : bx + cx] = typ
            occupied[by : by + cy, bx : bx + cx] = True
            first_sb[by, bx] = True
            positions.append((by, bx))
            left = code
            decoded += 1
    assert decoded == num_ac_blocks, (decoded, num_ac_blocks)
    state.strategy[by0 : by0 + ydb, bx0 : bx0 + xdb] = strat_sb
    state.is_first[by0 : by0 + ydb, bx0 : bx0 + xdb] = first_sb
    # Quant field tokens.
    qf = np.ones((ydb, xdb), np.int32)
    left = int(C.STRATEGY_CODE[strat_sb[0, 0]])
    for by, bx in positions:
        ctx = 3 if left > 11 else 4 if left > 5 else 5 if left > 3 else 6
        residual = unpack_signed(tok.read(ctx))
        cur = left + residual
        if not 0 <= cur <= 254:
            # raw quant field is uint8 in 1..255
            # (enc_adaptive_quantization.cc:518-534); an out-of-range delta
            # is a malformed stream, not a ZeroDivisionError later.
            raise DecodeError(f"quant field value {cur + 1} out of range")
        typ = strat_sb[by, bx]
        cy, cx = int(C.COVERED_Y[typ]), int(C.COVERED_X[typ])
        qf[by : by + cy, bx : bx + cx] = cur + 1
        left = cur
    state.raw_qf[by0 : by0 + ydb, bx0 : bx0 + xdb] = qf
    # EPF tokens.
    for _ in range(num_blocks):
        v = tok.read(0)
        assert unpack_signed(v) == 4

    # Dequantize DC into the LLF of the pixel planes later (in AC group pass).


def _decode_gradient_plane(tok, h, w, ctx_override=None):
    p = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            left = p[y, x - 1] if x else (p[y - 1, x] if y else 0)
            top = p[y - 1, x] if y else left
            topleft = p[y - 1, x - 1] if (x and y) else left
            grad = int(top + left - topleft)
            mn, mx = min(top, left), max(top, left)
            guess = mx if topleft < mn else mn if topleft > mx else grad
            if ctx_override is None:
                ctx = int(C.GRADIENT_CTX_LUT[np.clip(512 + grad, 0, 1023)])
            else:
                ctx = ctx_override
            p[y, x] = guess + unpack_signed(tok.read(ctx))
    return p


def _decode_ac_global(r, state):
    _expect(r, 1, 1, "default quant matrices")
    nb = (state.dim.num_groups - 1).bit_length()
    if nb:
        _expect(r, nb, 0, "num histograms")
    _expect(r, 2, 3, "coeff order selector")
    _expect(r, 13, 0, "coeff orders")
    cm, dec = read_histograms(r, C.NUM_AC_CONTEXTS)
    state.ac_tokens = (cm, dec)


def _adjust_quant_bias_scalar(q, c):
    if q == 0:
        return 0.0
    if q == 1:
        return float(C.DEFAULT_QUANT_BIAS[c])
    if q == -1:
        return -float(C.DEFAULT_QUANT_BIAS[c])
    return q - float(C.DEFAULT_QUANT_BIAS[3]) / q


def _decode_ac_group(r, state, idx):
    dim = state.dim
    gy, gx = divmod(idx, dim.xsize_groups)
    by0, bx0 = gy * 32, gx * 32
    yb = min(32, dim.ysize_blocks - by0)
    xb = min(32, dim.xsize_blocks - bx0)
    cm, dec = state.ac_tokens
    tok = TokenReader(r, cm, dec)
    nz_map = np.zeros((3, 32, 32), np.int32)
    scale = state.scale
    scale_dc = state.scale_dc
    inv_dc = (1.0 / (C.INV_DC_QUANT * scale_dc)).astype(np.float64)
    cfl_b = float(C.INV_DC_QUANT[2] * C.DC_QUANT[1])

    order8 = C.COEFF_ORDER8
    order16 = C.COEFF_ORDER16

    for by in range(yb):
        for bx in range(xb):
            gby, gbx = by0 + by, bx0 + bx
            if not state.is_first[gby, gbx]:
                continue
            typ = int(state.strategy[gby, gbx])
            cbx, cby = int(C.COVERED_X[typ]), int(C.COVERED_Y[typ])
            covered = cbx * cby
            size = covered * 64
            order = order8 if typ == C.DCT8 else order16
            quant = int(state.raw_qf[gby, gbx])
            strat_code = int(C.STRATEGY_CODE[typ])
            coeffs = np.zeros((3, size), np.float64)
            quantized = np.zeros((3, size), np.int64)
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
                nzero_ctx = bucket * C.NUM_BLOCK_CTXS + block_ctx
                nzeros = tok.read(nzero_ctx)
                shifted = -(-nzeros // covered)
                nz_map[c, by : by + cby, bx : bx + cbx] = shifted
                zd_off = (
                    C.NUM_BLOCK_CTXS * C.NONZERO_BUCKETS
                    + C.ZERO_DENSITY_CONTEXT_COUNT * block_ctx
                )
                prev = 0 if nzeros > (size >> 4) else 1
                nleft = nzeros
                k = covered
                while k < size and nleft:
                    nl_s = -(-nleft // covered)
                    ctx = zd_off + (
                        int(C.COEFF_NNZ_CTX[nl_s])
                        + int(C.COEFF_FREQ_CTX[k >> (covered - 1)])
                    ) * 2 + prev
                    coeff = unpack_signed(tok.read(ctx))
                    quantized[c, order[k]] = coeff
                    prev = 1 if coeff else 0
                    nleft -= prev
                    k += 1
            # Dequantize (inverse of QuantizeBlockAC + AdjustQuantBias).
            dqm = (
                C.DEQUANT_DCT8.reshape(3, 64)
                if typ == C.DCT8
                else C.DEQUANT_DCT16.reshape(3, 128)
            )
            inv_qac = 1.0 / (scale * quant)
            for c in range(3):
                adj = np.array(
                    [_adjust_quant_bias_scalar(int(q), c) for q in quantized[c]]
                )
                mul = inv_qac
                coeffs[c] = adj * dqm[c] * mul
            # CfL apply (decoder side): x += fx * y, b += fb * y.
            t_y, t_x = (by0 + by) // 8, (bx0 + bx) // 8
            fx = float(state.ytox[t_y, t_x]) * float(C.INV_COLOR_FACTOR)
            fb = 1.0 + float(state.ytob[t_y, t_x]) * float(C.INV_COLOR_FACTOR)
            coeffs[0] += fx * coeffs[1]
            coeffs[2] += fb * coeffs[1]
            # X channel qm multiplier: encoder quantized with *x_qm_mul.
            coeffs[0] /= state.x_qm_mul
            # DC -> LLF (inverse of DCFromLowestFrequencies).
            for c in range(3):
                dcs = []
                for iy in range(cby):
                    for ix in range(cbx):
                        q = float(state.quant_dc[c, gby + iy, gbx + ix])
                        if c == 2:
                            q = q + state.quant_dc[1, gby + iy, gbx + ix] * cfl_b
                        dcs.append(q * inv_dc[c])
                if covered == 1:
                    coeffs[c, 0] = dcs[0]
                else:
                    s = float(C.DCT_SCALE_16_TO_2)
                    coeffs[c, 0] = 0.5 * (dcs[0] + dcs[1])
                    coeffs[c, 1] = 0.5 * (dcs[0] - dcs[1]) / s
            # IDCT.
            rows, cols = cby * 8, cbx * 8
            for c in range(3):
                shaped = coeffs[c].reshape(8, size // 8)
                pix = idct2d_blocks(shaped.astype(np.float32), rows, cols)
                state.pixels[
                    c,
                    (by0 + by) * 8 : (by0 + by) * 8 + rows,
                    (bx0 + bx) * 8 : (bx0 + bx) * 8 + cols,
                ] = pix


def xyb_to_linear(xyb):
    """Inverse of ToXYB (enc_xyb.cc:44-81)."""
    x, y, b = xyb[0], xyb[1], xyb[2]
    tm0 = y + x
    tm1 = y - x
    tm2 = b
    tm = np.stack([tm0, tm1, tm2])
    mixed = (tm - C.NEG_BIAS_CBRT) ** 3 - C.OPSIN_BIAS
    minv = np.linalg.inv(C.OPSIN_MATRIX.astype(np.float64))
    return np.einsum("ij,jhw->ihw", minv, mixed).astype(np.float32)
