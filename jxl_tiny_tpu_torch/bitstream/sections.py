"""Section builders: file and frame headers, DC global, AC global, the TOC
with section assembly, and the host-built DC group and AC group sections of
the numpy and host-packed paths (the device-packed path packs those two on
the card: ops.dc_kernels and ops.pack_kernels).

A host-built section is a list of ops:
  ("bits", nbits, value)            raw bits
  ("tokens", ctx_arr, val_arr)      entropy-coded tokens (numpy arrays)
  ("stream", u32_arr)               entropy-coded (ctx << 16) | value words
Token histograms are gathered across sections, clustered, and the sections
are then serialized with the final codes: the two-pass scheme of the
reference (enc_frame.cc:765-802).

Copy of the JAX package's bitstream/sections.py (reference: enc_file.cc,
enc_frame.cc:287-595), numpy and the native packer (cpp/).
"""
import functools

import numpy as np

from .. import constants as C
from ..common import DistanceParams
from ..cpp.build import histogram_tokens, native_packer, pack_tokens
from ..entropy import build_entropy_code, write_entropy_code, write_tokens
from ..entropy.entropy_write import EntropyCode, write_context_map
from ..entropy.uint_coder import uint_encode
from ..utils.profiling import span
from .bit_writer import BitItems, BitWriter


def pack_signed(v):
    v = np.asarray(v, np.int64)
    return np.where(v >= 0, 2 * v, -2 * v - 1).astype(np.uint32)


def ceil_log2_nonzero(x: int) -> int:
    return (x - 1).bit_length()


# ---------------------------------------------------------------------------
# Headers
# ---------------------------------------------------------------------------


def write_size(writer, size):
    """enc_file.cc:28-38."""
    size -= 1
    for i, nb in enumerate((9, 13, 18, 30)):
        if size < (1 << nb):
            writer.write(2, i)
            writer.write(nb, size)
            return
    raise ValueError("image too large")


def write_file_header(writer, xsize, ysize):
    """Codestream signature + SizeHeader + ImageMetadata (enc_file.cc:70-94)."""
    writer.write(8, 0xFF)
    writer.write(8, 0x0A)
    writer.write(1, 0)  # not small
    write_size(writer, ysize)
    writer.write(3, 0)  # ratio
    write_size(writer, xsize)
    for nb, v in (
        (1, 0),  # not all default image metadata
        (1, 0),  # no extra fields
        (1, 1),  # floating point samples
        (2, 0),  # 32 bits per sample
        (4, 7),  # 8 exponent bits
        (1, 0),  # modular 16 bit not sufficient
        (2, 0),  # no extra channels
        (1, 1),  # xyb encoded
        (1, 0),  # color encoding not all default
        (1, 0),  # no icc
        (2, 0),  # RGB color space
        (2, 1),  # D65
        (2, 1),  # sRGB primaries
        (1, 0),  # no gamma
        (2, 2),  # transfer function selector
        (4, 6),  # linear transfer function
        (2, 1),  # relative rendering intent
        (2, 0),  # no extensions
        (1, 1),  # all default transform data
    ):
        writer.write(nb, v)
    writer.zero_pad_to_byte()


def write_frame_header(writer, x_qm_scale, epf_iters):
    """enc_frame.cc:426-457."""
    writer.write(1, 0)  # not all default
    writer.write(2, 0)  # regular frame
    writer.write(1, 0)  # vardct
    writer.write(2, 2)  # flags selector (17..272)
    writer.write(8, 111)  # flags = 128: skip adaptive DC smoothing
    writer.write(2, 0)  # no upsampling
    writer.write(3, x_qm_scale)
    writer.write(3, 2)  # b_qm_scale
    writer.write(2, 0)  # one pass
    writer.write(1, 0)  # no custom size/origin
    writer.write(2, 0)  # replace blend mode
    writer.write(1, 1)  # last frame
    writer.write(2, 0)  # no name
    if epf_iters == 2:
        writer.write(1, 1)  # default loop filter (gaborish on, epf 2)
    else:
        writer.write(1, 0)
        writer.write(1, 0)  # no gaborish
        writer.write(2, epf_iters)
        if epf_iters > 0:
            writer.write(1, 0)  # default epf sharpness
            writer.write(1, 0)  # default epf weights
            writer.write(1, 0)  # default epf sigma
        writer.write(2, 0)  # no loop filter extensions
    writer.write(2, 0)  # no frame header extensions


def write_quant_scales(writer, global_scale, quant_dc):
    """enc_frame.cc:459-485."""
    if global_scale < 2049:
        writer.write(2, 0)
        writer.write(11, global_scale - 1)
    elif global_scale < 4097:
        writer.write(2, 1)
        writer.write(11, global_scale - 2049)
    elif global_scale < 8193:
        writer.write(2, 2)
        writer.write(12, global_scale - 4097)
    else:
        writer.write(2, 3)
        writer.write(16, global_scale - 8193)
    if quant_dc == 16:
        writer.write(2, 0)
    elif quant_dc < 33:
        writer.write(2, 1)
        writer.write(5, quant_dc - 1)
    elif quant_dc < 257:
        writer.write(2, 2)
        writer.write(8, quant_dc - 1)
    else:
        writer.write(2, 3)
        writer.write(16, quant_dc - 1)


# ---------------------------------------------------------------------------
# Global sections
# ---------------------------------------------------------------------------


def _write_compact_block_ctx_map(writer):
    """Non-default BlockCtxMap (enc_frame.cc:509-515)."""
    writer.write(1, 0)  # not all default
    writer.write(16, 0)  # no dc thresholds, no qf thresholds
    code = EntropyCode(
        context_map=C.COMPACT_BLOCK_CTX_MAP.astype(np.uint8),
        depths=np.zeros((0, C.ALPHABET_SIZE), np.uint8),
        bits=np.zeros((0, C.ALPHABET_SIZE), np.uint16),
    )
    write_context_map(code, writer)


def _write_context_tree(writer, num_dc_groups):
    """Fixed modular context tree (enc_frame.cc:487-502)."""
    tokens = C.CONTEXT_TREE_TOKENS.copy()
    tokens[1, 1] = pack_signed(np.array([1 + num_dc_groups]))[0]
    ctx = tokens[:, 0].astype(np.int64)
    val = tokens[:, 1].astype(np.uint32)
    histo = np.zeros((C.NUM_TREE_CONTEXTS, C.ALPHABET_SIZE), np.uint32)
    tok, _, _ = uint_encode(val)
    np.add.at(histo, (ctx, tok), 1)
    code = build_entropy_code(histo)
    writer.write(1, 1)  # not an empty tree
    writer.write(1, 0)  # no lz77
    write_entropy_code(code, writer)
    write_tokens(ctx, val, code, writer)


@functools.lru_cache(maxsize=32)
def dc_global_invariant(num_dc_groups):
    """The DC global's bits past its quant scales up to its DC code, as
    (nbits u8, values u64), read-only: the compact block context map, the
    default colour correlation, the context tree with its code and tokens,
    no LZ77. They depend on num_dc_groups alone, so they are built once a
    value (span assembly.globals.prefix) and appended as they are."""
    with span("assembly.globals.prefix"):
        items = BitItems()
        _write_compact_block_ctx_map(items)
        items.write(1, 1)  # default DC color correlation map
        _write_context_tree(items, num_dc_groups)
        items.write(1, 0)  # no lz77
        nbits, values = items.arrays()
    nbits.flags.writeable = values.flags.writeable = False
    return nbits, values


def write_dc_global(writer, distp: DistanceParams, num_dc_groups, dc_code):
    """enc_frame.cc:504-521, reaching `writer` as one write_arrays."""
    items = BitItems()
    items.write(1, 1)  # default dequant dc
    write_quant_scales(items, distp.global_scale, distp.quant_dc)
    items.write_arrays(*dc_global_invariant(num_dc_groups))
    write_entropy_code(dc_code, items)
    writer.write_arrays(*items.arrays())


def write_ac_global(writer, num_groups, ac_code):
    """enc_frame.cc:523-534, reaching `writer` as one write_arrays."""
    items = BitItems()
    items.write(1, 1)  # all default quant matrices
    nb = ceil_log2_nonzero(num_groups)
    if nb:
        items.write(nb, 0)  # one histogram group
    items.write(2, 3)
    items.write(13, 0)  # all default coeff orders
    items.write(1, 0)  # no lz77
    write_entropy_code(ac_code, items)
    writer.write_arrays(*items.arrays())


# ---------------------------------------------------------------------------
# DC group section (token ops)
# ---------------------------------------------------------------------------


def _gradient_tokens(plane):
    """Clamped-gradient prediction over a 2-D int plane (enc_frame.cc:287-316).

    Returns (ctx ids, packed residuals), raster order.
    """
    p = plane.astype(np.int64)
    left = np.empty_like(p)
    left[:, 1:] = p[:, :-1]
    left[1:, 0] = p[:-1, 0]
    left[0, 0] = 0
    top = np.empty_like(p)
    top[1:] = p[:-1]
    top[0] = left[0]
    topleft = np.empty_like(p)
    topleft[1:, 1:] = p[:-1, :-1]
    topleft[0, :] = left[0, :]
    topleft[1:, 0] = left[1:, 0]
    grad = top + left - topleft
    mn = np.minimum(top, left)
    mx = np.maximum(top, left)
    guess = np.where(topleft < mn, mx, np.where(topleft > mx, mn, grad))
    gradprop = np.clip(C.GRAD_RANGE_MID + grad, 0, 1023)
    ctx = C.GRADIENT_CTX_LUT[gradprop]
    residual = p - guess
    return ctx.ravel().astype(np.int64), pack_signed(residual.ravel())


def build_dc_group_section(quant_dc, raw_qf, strategy_code, is_first, ytox, ytob):
    """Ops for one DC group section (enc_frame.cc:536-570).

    quant_dc: [3, yb, xb] (X, Y, B); raw_qf: [yb, xb] u8 (post AdjustQuantField);
    strategy_code: [yb, xb] tokenized codes (0/6/7); is_first: [yb, xb] bool;
    ytox/ytob: [ty, tx] int8.
    """
    ops = []
    ops.append(("bits", 2, 0))  # extra_dc_precision
    ops.append(("bits", 4, 3))  # use global tree, default wp, no transforms
    # DC tokens, channel order Y, X, B (enc_frame.cc:292).
    for c in (1, 0, 2):
        ctx, val = _gradient_tokens(quant_dc[c])
        ops.append(("tokens", ctx, val))
    yb, xb = raw_qf.shape
    num_blocks = yb * xb
    num_ac_blocks = int(is_first.sum())
    nb = ceil_log2_nonzero(num_blocks)
    if nb:
        ops.append(("bits", nb, num_ac_blocks - 1))
    ops.append(("bits", 4, 3))  # use global tree, default wp, no transforms
    # AC metadata (enc_frame.cc:329-424): ytox map (ctx 2), ytob map (ctx 1).
    for c, cm in ((0, ytox), (1, ytob)):
        ctx, val = _gradient_tokens(cm.astype(np.int64))
        ops.append(("tokens", np.full_like(ctx, 2 - c), val))
    # AC strategy tokens (ctx from previous code).
    codes = strategy_code[is_first].astype(np.int64)  # raster order
    prev = np.concatenate([[0], codes[:-1]])
    ctx = np.where(prev > 11, 7, np.where(prev > 5, 8, np.where(prev > 3, 9, 10)))
    ops.append(("tokens", ctx, pack_signed(codes)))
    # Quant field tokens (delta vs previous, ctx from previous value).
    cur = raw_qf[is_first].astype(np.int64) - 1
    left0 = int(strategy_code[0, 0])
    prev = np.concatenate([[left0], cur[:-1]])
    ctx = np.where(prev > 11, 3, np.where(prev > 5, 4, np.where(prev > 3, 5, 6)))
    ops.append(("tokens", ctx, pack_signed(cur - prev)))
    # EPF tokens: one per 8x8 block, value PackSigned(4), ctx 0.
    ops.append(
        (
            "tokens",
            np.zeros(num_blocks, np.int64),
            np.full(num_blocks, 8, np.uint32),  # PackSigned(4) == 8
        )
    )
    return ops


def dc_context_token_masks():
    """[NUM_DC_CONTEXTS, ALPHABET_SIZE] bool: which hybrid-uint tokens can
    ever occur in each DC-section context, from format invariants (not from
    corpus statistics). Every static DC candidate code must give each of
    these tokens a code (entropy_write.load_static_codes checks it).

    Bounds per build_dc_group_section and the device's DC-section layout
    (ops/dc_kernels.build_dc_layout), enc_frame.cc:287-424:
      ctx 0       EPF: value PackSigned(4)=8 always           -> {8}
      ctx 1,2     ytob/ytox gradient residual of int8 maps:
                  |residual| <= 255 -> PackSigned <= 511       -> tokens <= 35
      ctx 3-6     quant-field delta: cur,prev in [0,254]
                  -> PackSigned <= 509                         -> tokens <= 35
      ctx 7-10    strategy PackSigned({0,6,7}) = {0,12,14}     -> {0,12,14}
      ctx 11-44   DC gradient residual; quant_dc clamps at
                  +/-16383 (saturating quantizer)              -> all 64
    """
    m = np.zeros((C.NUM_DC_CONTEXTS, C.ALPHABET_SIZE), bool)
    m[0, 8] = True
    m[1:7, :36] = True
    m[7:11, [0, 12, 14]] = True
    m[11:, :] = True
    return m


# ---------------------------------------------------------------------------
# AC group section (token ops from per-cell token arrays)
# ---------------------------------------------------------------------------


def ac_group_token_stream(tokens, counts, strategy, is_first):
    """Order the per-cell token arrays into the emission sequence.

    tokens: [yb, xb, 3, 64] u32 (ctx<<16|val); counts: [yb, xb, 3];
    strategy: [yb, xb] raw type; is_first: [yb, xb] bool (valid cells only).
    Emission: raster over first cells, channels Y, X, B, sequence per channel
    spanning first + continuation cell.
    """
    yb, xb, _, _ = tokens.shape
    cell_idx = np.arange(yb * xb).reshape(yb, xb)
    # Owning first-cell index per cell.
    owner = cell_idx.copy()
    strat = strategy
    second_v = np.zeros((yb, xb), bool)
    second_v[1:] = (strat[:-1] == C.DCT16X8) & is_first[:-1]
    second_h = np.zeros((yb, xb), bool)
    second_h[:, 1:] = (strat[:, :-1] == C.DCT8X16) & is_first[:, :-1]
    owner[second_v] = (cell_idx - xb)[second_v]
    owner[second_h] = (cell_idx - 1)[second_h]
    is_cont = second_v | second_h

    slot = np.arange(64)
    valid = slot[None, None, None, :] < counts[..., None]  # [yb, xb, 3, 64]
    chan_rank = np.array([1, 0, 2])  # X->1, Y->0, B->2 emission rank
    key = (
        (owner[..., None, None].astype(np.int64) * 3 + chan_rank[None, None, :, None])
        * 128
        + slot[None, None, None, :]
        + np.where(is_cont, 64, 0)[..., None, None]
    )
    keys = key[valid]
    toks = tokens[valid]
    order = np.argsort(keys, kind="stable")
    stream = toks[order]
    return (stream >> 16).astype(np.int64), (stream & 0xFFFF).astype(np.uint32)


def build_ac_group_section(tokens, counts, strategy, is_first):
    ctx, val = ac_group_token_stream(tokens, counts, strategy, is_first)
    return [("tokens", ctx, val)]


# ---------------------------------------------------------------------------
# Two-pass entropy optimization and serialization
# ---------------------------------------------------------------------------


def _op_stream_u32(op):
    """A token op as one (ctx << 16) | value u32 array."""
    if op[0] == "stream":
        return np.ascontiguousarray(op[1], np.uint32)
    _, ctx, val = op
    if int(val.max(initial=0)) > 0xFFFF:
        raise ValueError("token value exceeds 16 bits")
    return ((ctx.astype(np.uint32) << 16) | val.astype(np.uint32)).astype(np.uint32)


def histogram_sections(section_ops_list, num_contexts):
    """[num_contexts, ALPHABET_SIZE] u32 token counts over the sections'
    token ops (the native histogram where g++ could build it, else numpy;
    the same counts)."""
    native = native_packer() is not None
    histo = np.zeros((num_contexts, C.ALPHABET_SIZE), np.uint32)
    for ops in section_ops_list:
        for op in ops:
            if op[0] == "bits":
                continue
            s = _op_stream_u32(op)
            if native:
                histo += histogram_tokens(s, num_contexts)
            else:
                tok, _, _ = uint_encode(s & 0xFFFF)
                np.add.at(histo, ((s >> 16).astype(np.int64), tok), 1)
    return histo


def serialize_section(ops, code: EntropyCode) -> BitWriter:
    """One section's ops entropy-coded with `code` (the native pack_tokens
    where g++ could build it, else numpy; the same bits)."""
    native = native_packer() is not None
    w = BitWriter()
    for op in ops:
        if op[0] == "bits":
            w.write(op[1], op[2])
        elif native:
            data, nbits = pack_tokens(_op_stream_u32(op), code.context_map,
                                      code.token_depths, code.bits)
            w.append_writer(BitWriter.from_packed(np.frombuffer(data, np.uint8), nbits))
        elif op[0] == "stream":
            s = op[1]
            write_tokens((s >> 16).astype(np.int64), s & 0xFFFF, code, w)
        else:
            _, ctx, val = op
            write_tokens(ctx, val, code, w)
    return w


# TOC entry classes (enc_frame.cc:578-595): a size below the first offset
# goes in 10 bits, below the second less the first in 14, and so on.
_TOC_WIDTHS = np.array([10, 14, 22, 30], np.int64)
_TOC_OFFSETS = np.concatenate([[0], np.cumsum(1 << _TOC_WIDTHS)])


def merge_sections(sections):
    """The four sections of a one-group frame as the one section its single
    TOC entry covers: their bits concatenated with no padding between them
    (enc_frame.cc:572-577). sections: (byte image u8, bit count) each."""
    merged = BitWriter()
    for raw, nbits in sections:
        merged.append_writer(BitWriter.from_packed(raw, nbits))
    return merged.to_section()


def write_toc(writer, sections):
    """The TOC (enc_frame.cc:578-595) of `sections`, (byte image u8, bit
    count) each, a one-group frame's merged first (merge_sections): no
    permutation, each section's byte size, padding to a byte."""
    sizes = np.array([(nbits + 7) >> 3 for _, nbits in sections], np.int64)
    cls = np.searchsorted(_TOC_OFFSETS, sizes, side="right") - 1
    if (cls >= len(_TOC_WIDTHS)).any():
        raise ValueError("section too large")
    writer.write(1, 0)  # no permutation
    writer.zero_pad_to_byte()
    writer.write_arrays(np.stack([np.full_like(cls, 2), _TOC_WIDTHS[cls]], 1),
                        np.stack([cls, sizes - _TOC_OFFSETS[cls]], 1))
    writer.zero_pad_to_byte()


def join_sections(head: bytes, sections) -> bytes:
    """The codestream: `head` (headers and TOC, whole bytes) followed by
    every section's bytes (enc_frame.cc:804-814), each section starting on
    a byte; the bits of a section's last byte past its bit count are
    cleared. sections: (byte image u8 holding at least the section's
    bytes, bit count) each."""
    nbits = np.array([n for _, n in sections], np.int64)
    sizes = (nbits + 7) >> 3
    buf = np.concatenate([np.frombuffer(head, np.uint8)]
                         + [raw[:size] for (raw, _), size in zip(sections, sizes.tolist())])
    rem = nbits & 7
    part = rem > 0
    last = len(head) + np.cumsum(sizes) - 1
    buf[last[part]] &= ((1 << rem[part]) - 1).astype(np.uint8)
    return buf.tobytes()
