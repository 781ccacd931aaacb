"""Codestream writers for the device-packed path: file and frame headers,
DC global, AC global, and the TOC with section assembly (the DC group and
AC group sections themselves are packed on the device; ops.dc_kernels and
ops.pack_kernels).

Copy of the JAX package's bitstream/sections.py writers (reference:
enc_file.cc, enc_frame.cc:426-595), numpy only.
"""
import numpy as np

from .. import constants as C
from ..common import DistanceParams
from ..entropy import build_entropy_code, write_entropy_code, write_tokens
from ..entropy.entropy_write import EntropyCode
from ..entropy.uint_coder import uint_encode
from .bit_writer import BitWriter


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
    from ..entropy.entropy_write import write_context_map

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


def write_dc_global(writer, distp: DistanceParams, num_dc_groups, dc_code):
    """enc_frame.cc:504-521."""
    writer.write(1, 1)  # default dequant dc
    write_quant_scales(writer, distp.global_scale, distp.quant_dc)
    _write_compact_block_ctx_map(writer)
    writer.write(1, 1)  # default DC color correlation map
    _write_context_tree(writer, num_dc_groups)
    writer.write(1, 0)  # no lz77
    write_entropy_code(dc_code, writer)


def write_ac_global(writer, num_groups, ac_code):
    """enc_frame.cc:523-534."""
    writer.write(1, 1)  # all default quant matrices
    nb = ceil_log2_nonzero(num_groups)
    if nb:
        writer.write(nb, 0)  # one histogram group
    writer.write(2, 3)
    writer.write(13, 0)  # all default coeff orders
    writer.write(1, 0)  # no lz77
    write_entropy_code(ac_code, writer)


def dc_context_token_masks():
    """[NUM_DC_CONTEXTS, ALPHABET_SIZE] bool: which hybrid-uint tokens can
    ever occur in each DC-section context, from format invariants (not from
    corpus statistics). Every static DC candidate code must give each of
    these tokens a code (entropy_write.load_static_codes checks it).

    Bounds per the DC-section layout (ops/dc_kernels.build_dc_layout,
    enc_frame.cc:287-424):
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


def write_toc_and_sections(writer, sections):
    """enc_frame.cc:572-595,804-814. sections: list of BitWriter."""
    if len(sections) == 4:
        merged = BitWriter()
        for s in sections:
            merged.append_writer(s)
        sections = [merged]
    writer.write(1, 0)  # no permutation
    writer.zero_pad_to_byte()
    for s in sections:
        size = (s.bits_written + 7) // 8
        offset = 0
        for i, nb in enumerate((10, 14, 22, 30)):
            if size < offset + (1 << nb):
                writer.write(2, i)
                writer.write(nb, size - offset)
                break
            offset += 1 << nb
        else:
            raise ValueError("section too large")
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes_aligned(s.to_bytes())
