"""JPEG XL format constants for the tiny VarDCT encoder subset.

Large tables live in ``tables.npz`` (extracted from the reference sources by
``tools/gen_constants.py``; see that file for per-table provenance). Small
scalar constants are defined inline here with citations.
"""
import os

import numpy as np

_TABLES = np.load(os.path.join(os.path.dirname(__file__), "tables.npz"))

# --- Geometry (reference: encoder/common.h:34-46) ---
BLOCK_DIM = 8
BLOCK_SIZE = 64
GROUP_DIM = 256
GROUP_DIM_BLOCKS = 32
DC_GROUP_DIM = 2048
TILE_DIM = 64  # color tile (OPTIMIZE_CHROMA_FROM_LUMA tier)
TILE_DIM_BLOCKS = 8
GROUP_DIM_TILES = 4

# --- Strategies (reference: encoder/ac_strategy.h:38-44,59-62) ---
DCT8 = 0
DCT16X8 = 1  # 8 px wide, 16 px tall (2 blocks stacked vertically)
DCT8X16 = 2  # 16 px wide, 8 px tall (2 blocks side by side)
STRATEGY_CODE = np.array([0, 6, 7], dtype=np.int32)  # tokenized codes
COVERED_X = np.array([1, 1, 2], dtype=np.int32)
COVERED_Y = np.array([1, 2, 1], dtype=np.int32)

# --- Color transform: linear sRGB -> XYB (reference: encoder/enc_xyb.cc:30-40) ---
_M02 = 0.078
_M00 = 0.30
_M01 = 1.0 - _M02 - _M00
_M12 = 0.078
_M10 = 0.23
_M11 = 1.0 - _M12 - _M10
_M20 = 0.24342268924547819
_M21 = 0.20476744424496821
_M22 = 1.0 - _M20 - _M21
OPSIN_MATRIX = np.array(
    [[_M00, _M01, _M02], [_M10, _M11, _M12], [_M20, _M21, _M22]], dtype=np.float32
)
OPSIN_BIAS = np.float32(0.0037930732552754493)
NEG_BIAS_CBRT = np.float32(-0.15595420054)

# --- DC quantization (reference: encoder/quant_weights.h:22-32) ---
INV_DC_QUANT = np.array([4096.0, 512.0, 256.0], dtype=np.float32)  # X, Y, B
DC_QUANT = (1.0 / INV_DC_QUANT).astype(np.float32)

# --- Dequant matrices (reference: encoder/quant_weights.cc) ---
# dequant_dct8: [c, yfreq? see note] -- stored in *coefficient layout* order,
# i.e. the same raster order as the DCT output blocks: for DCT8 the layout is
# [xfreq, yfreq] (8x8, symmetric so orientation is moot); for the shared
# 16-coefficient-long-axis table the layout is 8 rows (short-axis freq) x 16
# cols (long-axis freq), LLF at (0,0) and (0,1).
DEQUANT_DCT8 = _TABLES["dequant_dct8"].astype(np.float32)  # [3,8,8] (X,Y,B)
DEQUANT_DCT16 = _TABLES["dequant_dct16"].astype(np.float32)  # [3,8,16]
# Inverse (quant) matrices with LLF slots zeroed (quant_weights.cc:140-157).
QUANT_DCT8 = (1.0 / DEQUANT_DCT8).astype(np.float32)
QUANT_DCT8[:, 0, 0] = 0.0
QUANT_DCT16 = (1.0 / DEQUANT_DCT16).astype(np.float32)
QUANT_DCT16[:, 0, 0] = 0.0
QUANT_DCT16[:, 0, 1] = 0.0

# --- Coefficient scan orders (reference: encoder/enc_group.cc:166-183) ---
COEFF_ORDER8 = _TABLES["coeff_order8"]  # [64]
COEFF_ORDER16 = _TABLES["coeff_order16"]  # [128], shared by 16x8 and 8x16

# --- AC token contexts (reference: encoder/ac_context.h) ---
NONZERO_BUCKETS = 37
ZERO_DENSITY_CONTEXT_COUNT = 458
NUM_BLOCK_CTXS = 4
NUM_AC_CONTEXTS = NUM_BLOCK_CTXS * (NONZERO_BUCKETS + ZERO_DENSITY_CONTEXT_COUNT)
COEFF_FREQ_CTX = _TABLES["coeff_freq_ctx"]  # [64]
COEFF_NNZ_CTX = _TABLES["coeff_nnz_ctx"]  # [64]
BLOCK_CTX_MAP = _TABLES["block_ctx_map"]  # [3(c: X,Y,B), 27(strategy code)]
COMPACT_BLOCK_CTX_MAP = _TABLES["compact_block_ctx_map"]  # [39], serialized form

# --- DC / control-field contexts (reference: encoder/enc_frame.cc:224-285) ---
NUM_DC_CONTEXTS = 45
GRADIENT_CTX_LUT = _TABLES["gradient_ctx_lut"]  # [1024]
GRAD_RANGE_MID = 512
CONTEXT_TREE_TOKENS = _TABLES["context_tree_tokens"]  # [313, 2] (ctx, value)
NUM_TREE_CONTEXTS = 6

# --- Entropy coding (reference: encoder/entropy_code.h:16-17) ---
ALPHABET_SIZE = 64
MAX_CONTEXTS = 128
CLUSTERS_LIMIT = 8  # enc_cluster.cc:122

# --- Quantizer biases (reference: encoder/enc_group.cc:290-295) ---
DEFAULT_QUANT_BIAS = np.array(
    [
        1.0 - 0.05465007330715401,  # X
        1.0 - 0.07005449891748593,  # Y
        1.0 - 0.049935103337343655,  # B
        0.145,
    ],
    dtype=np.float32,
)

# --- Chroma-from-luma (reference: encoder/chroma_from_luma.h:21-24) ---
INV_COLOR_FACTOR = np.float32(1.0 / 84)

# --- DCT LLF resampling scales (reference: encoder/dct_scales.h:53-58) ---
DCT_SCALE_16_TO_2 = np.float32(0.901764195028874394)

# --- Saturating-quantizer clamps (TPU-build deviation, documented) ---
# The 64-symbol hybrid-uint alphabet (entropy_code.h:16, token.h:24-48) tops
# out at token 63, i.e. token values < 2^16. PackSigned therefore requires
# |AC coefficient| <= 32767, and |DC value| <= 16383 (the clamped-gradient
# DC residual of two in-range values stays < 2^15, so its PackSigned fits
# 16 bits). The reference stores DC as int16 (dc_group_data.h, Image3S) and
# would silently wrap / emit out-of-alphabet tokens on the same extreme-HDR
# content; this build saturates at the quantizer instead — the stream stays
# valid and decodable, and all pipelines (numpy golden, XLA, Pallas)
# saturate identically so cross-pipeline bit-equality holds.
AC_COEF_CLAMP = 32767
DC_VALUE_CLAMP = 16383

# --- DC-section layout entries (ops/dc_kernels.py) ---
DC_RAW = 0x8000  # tag bit of an entry emitted as raw bits (low byte: count)
DC_PAD = 0xFFFF  # tag of a zero-width padding entry
# The two raw entries that open every DC section (EncoderTables.dc_header
# on the device): 2 bits of 0, then 4 bits of 3.
DC_HEADER = (((DC_RAW | 2) << 16) | 0, ((DC_RAW | 4) << 16) | 3)
