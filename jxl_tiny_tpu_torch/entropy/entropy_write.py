"""Serialization of prefix codes and context maps (Brotli-style), plus token
emission.

Byte-exact reproduction of the format written by the reference
(encoder/enc_entropy_code.cc): hybrid-uint configs, alphabet sizes, simple
trees, RLE tree-of-trees, context maps coded through a nested prefix code.
These are bitstream-format obligations; a conforming decoder reads exactly
this layout. The writers take a BitWriter or a BitItems (bitstream.bit_writer)
and emit a tree's or a map's items as arrays, not one write a field.
"""
import collections
import dataclasses
import functools
import itertools
import os

import numpy as np

from ..constants import ALPHABET_SIZE
from .huffman import create_huffman_depths, depths_to_bits
from .cluster import cluster_histograms
from .uint_coder import uint_encode

_CODE_LENGTH_CODES = 18
_STORAGE_ORDER = np.array([1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15])
# Static Huffman code over code-length bit depths (enc_entropy_code.cc:22-37).
_LEN_SYMBOLS = [0, 7, 3, 2, 1, 15]
_LEN_NBITS = [2, 4, 3, 2, 2, 4]
# Extra bits after a code-length code: 2 after 16 (repeat), 3 after 17 (zeros).
_EXTRA_NBITS = np.zeros(_CODE_LENGTH_CODES, np.uint8)
_EXTRA_NBITS[16], _EXTRA_NBITS[17] = 2, 3


@dataclasses.dataclass
class EntropyCode:
    context_map: np.ndarray  # [num_contexts] uint8 cluster ids
    depths: np.ndarray  # [num_clusters, ALPHABET_SIZE] uint8
    bits: np.ndarray  # [num_clusters, ALPHABET_SIZE] uint16
    # Depths used for token emission. Identical to `depths` except that
    # single-symbol clusters are 0-bit codes: the serialized form (simple tree
    # with NSYM=1) consumes no bits at decode time. (The reference's
    # CreateHuffmanTree leaves a fake depth of 1 in this case,
    # enc_huffman_tree.cc:84-87, and relies on clustering never producing
    # single-symbol histograms.)
    token_depths: np.ndarray = None

    def __post_init__(self):
        if self.token_depths is None:
            td = self.depths.copy()
            single = (td > 0).sum(axis=1) == 1
            td[single] = 0
            self.token_depths = td

    @property
    def num_clusters(self):
        return self.depths.shape[0]


def build_entropy_code(histograms: np.ndarray) -> EntropyCode:
    """histograms: [num_contexts, ALPHABET_SIZE] -> clustered + Huffman codes.

    Mirrors OptimizeEntropyCode (enc_entropy_code.cc:504-514): cluster to <=8,
    then 15-bit length-limited Huffman codes per cluster.
    """
    clustered, context_map = cluster_histograms(histograms)
    m = clustered.shape[0]
    depths = np.zeros((m, ALPHABET_SIZE), np.uint8)
    bits = np.zeros((m, ALPHABET_SIZE), np.uint16)
    for i in range(m):
        counts = clustered[i]
        length = ALPHABET_SIZE
        while length > 0 and counts[length - 1] == 0:
            length -= 1
        if length:
            depths[i, :length] = create_huffman_depths(counts[:length], 15)
            bits[i, :length] = depths_to_bits(depths[i, :length])
    return EntropyCode(context_map=context_map, depths=depths, bits=bits)


def write_tokens(ctx, values, code: EntropyCode, writer):
    """Vectorized WriteToken (enc_entropy_code.h:34-42) over token arrays."""
    ctx = np.asarray(ctx, np.int64)
    tok, nbits, bits = uint_encode(values)
    cluster = code.context_map[ctx].astype(np.int64)
    d = code.token_depths[cluster, tok].astype(np.int64)
    sym = code.bits[cluster, tok].astype(np.uint64)
    data = sym | (bits.astype(np.uint64) << d.astype(np.uint64))
    writer.write_arrays((d + nbits).astype(np.uint8), data)


# --- Huffman tree serialization ---


def _write_huffman_tree_rle(depths, length):
    """WriteHuffmanTree (enc_entropy_code.cc:232-275): returns (tree, extra).
    Walks the runs of equal depths, not the symbols: a run that is not
    run-length coded is its value repeated."""
    d = np.asarray(depths[:length]).tolist()
    while d and d[-1] == 0:
        d.pop()
    runs = [(value, len(list(group))) for value, group in itertools.groupby(d)]

    use_rle_nz = use_rle_z = False
    if length > 50:
        long_z = [r for value, r in runs if value == 0 and r >= 3]
        long_nz = [r for value, r in runs if value != 0 and r >= 4]
        use_rle_z = sum(long_z) > 2 * (1 + len(long_z))
        use_rle_nz = sum(long_nz) > 2 * (1 + len(long_nz))

    tree, extra = [], []
    previous_value = 8
    for value, r in runs:
        if value == 0 and use_rle_z:
            _rep_zeros(r, tree, extra)
        elif value != 0 and use_rle_nz:
            _rep_nonzero(previous_value, value, r, tree, extra)
        else:
            tree += [value] * r
            extra += [0] * r
        if value:
            previous_value = value
    return tree, extra


def _rep_nonzero(previous_value, value, repetitions, tree, extra):
    if previous_value != value:
        tree.append(value)
        extra.append(0)
        repetitions -= 1
    if repetitions == 7:
        tree.append(value)
        extra.append(0)
        repetitions -= 1
    if repetitions < 3:
        for _ in range(repetitions):
            tree.append(value)
            extra.append(0)
    else:
        repetitions -= 3
        chunk_t, chunk_e = [], []
        while True:
            chunk_t.append(16)
            chunk_e.append(repetitions & 3)
            repetitions >>= 2
            if repetitions == 0:
                break
            repetitions -= 1
        tree.extend(reversed(chunk_t))
        extra.extend(reversed(chunk_e))


def _rep_zeros(repetitions, tree, extra):
    if repetitions == 11:
        tree.append(0)
        extra.append(0)
        repetitions -= 1
    if repetitions < 3:
        for _ in range(repetitions):
            tree.append(0)
            extra.append(0)
    else:
        repetitions -= 3
        chunk_t, chunk_e = [], []
        while True:
            chunk_t.append(17)
            chunk_e.append(repetitions & 7)
            repetitions >>= 3
            if repetitions == 0:
                break
            repetitions -= 1
        tree.extend(reversed(chunk_t))
        extra.extend(reversed(chunk_e))


def _store_huffman_tree(depths, length, writer):
    """StoreHuffmanTree (enc_entropy_code.cc:326-376)."""
    tree, extra = _write_huffman_tree_rle(depths, length)
    distinct = set(tree)
    tree = np.array(tree, np.int64)
    histo = np.bincount(tree, minlength=_CODE_LENGTH_CODES).astype(np.uint32)

    len_depths = create_huffman_depths(histo, 5)
    len_bits = depths_to_bits(len_depths)

    # Tree of trees (StoreHuffmanTreeOfHuffmanTreeToBitMask).
    stored = len_depths[_STORAGE_ORDER].tolist()
    codes_to_store = _CODE_LENGTH_CODES
    if len(distinct) > 1:
        while codes_to_store > 0 and stored[codes_to_store - 1] == 0:
            codes_to_store -= 1
    skip_some = 0
    if stored[0] == 0 and stored[1] == 0:
        skip_some = 3 if stored[2] == 0 else 2
    writer.write(2, skip_some)
    for l in stored[skip_some:codes_to_store]:
        writer.write(_LEN_NBITS[l], _LEN_SYMBOLS[l])

    if len(distinct) == 1:
        len_depths[tree[0]] = 0

    # Each code-length code, then its extra bits (none but after 16, 17).
    nbits = np.empty((tree.size, 2), np.uint8)
    nbits[:, 0] = len_depths[tree]
    nbits[:, 1] = _EXTRA_NBITS[tree]
    values = np.empty((tree.size, 2), np.uint64)
    values[:, 0] = len_bits[tree]
    values[:, 1] = extra
    writer.write_arrays(nbits, values)


def _store_simple_tree(depths, symbols, num_symbols, max_bits, writer):
    """StoreSimpleHuffmanTree (enc_entropy_code.cc:85-116)."""
    writer.write(2, 1)
    writer.write(2, num_symbols - 1)
    symbols = [int(s) for s in symbols[:num_symbols]]
    for i in range(num_symbols):
        for j in range(i + 1, num_symbols):
            if depths[symbols[j]] < depths[symbols[i]]:
                symbols[i], symbols[j] = symbols[j], symbols[i]
    for s in symbols:
        writer.write(max_bits, s)
    if num_symbols == 4:
        writer.write(1, 1 if depths[symbols[0]] == 1 else 0)


def _write_prefix_code(depths, bits, writer):
    """WritePrefixCode (enc_entropy_code.cc:390-423)."""
    used = np.flatnonzero(depths)
    count = used.size
    length = int(used[-1]) + 1 if count else 1
    max_bits = (length - 1).bit_length()
    if count <= 1:
        writer.write(4, 1)
        writer.write(max_bits, int(used[0]) if count else 0)
        return
    if count <= 4:
        _store_simple_tree(depths, used[:4], count, max_bits, writer)
    else:
        _store_huffman_tree(depths, length, writer)


def _num_symbols(depths):
    """[M] the alphabet size of each row of depths [M, 64]: one past its
    last symbol with a code, 1 where none has."""
    nz = np.asarray(depths) != 0
    return np.where(nz.any(1), nz.shape[1] - np.argmax(nz[:, ::-1], axis=1), 1)


def _store_varlen_u16(n, writer):
    """StoreVarLenUint16 (enc_entropy_code.cc:378-388)."""
    assert 0 <= n <= 65535
    if n == 0:
        writer.write(1, 0)
    else:
        writer.write(1, 1)
        nbits = n.bit_length() - 1
        writer.write(4, nbits)
        writer.write(nbits, n - (1 << nbits))


def write_prefix_codes(depths, bits, writer):
    """WritePrefixCodes (enc_entropy_code.cc:425-453); depths/bits: [M, 64]."""
    m = depths.shape[0]
    writer.write(1, 1)  # use_prefix_code
    for _ in range(m):
        writer.write(4, 4)  # split_exponent
        writer.write(3, 2)  # msb_in_token
        writer.write(2, 0)  # lsb_in_token
    nsyms = _num_symbols(depths).tolist()
    for ns in nsyms:
        _store_varlen_u16(ns - 1, writer)
    for i, ns in enumerate(nsyms):
        if ns > 1:
            _write_prefix_code(depths[i], bits[i], writer)


def write_context_map(code: EntropyCode, writer):
    """WriteContextMap (enc_entropy_code.cc:516-549)."""
    num_contexts = len(code.context_map)
    if num_contexts == 0:
        return
    if int(code.context_map.max()) == 0:
        writer.write(3, 1)  # simple code, 0 bits per entry
        return
    writer.write(3, 0)  # not simple, no MTF, no LZ77
    values = code.context_map.astype(np.uint32)
    # One nested prefix code trained on the map values (no clustering).
    tok, _, _ = uint_encode(values)
    histo = np.bincount(tok, minlength=ALPHABET_SIZE)[None]
    nested = build_entropy_code_from_cluster_histograms(histo)
    write_prefix_codes(nested.depths, nested.bits, writer)
    write_tokens(np.zeros(len(values), np.int64), values, nested, writer)


def build_ac_device_code(hist64: np.ndarray, base_map: np.ndarray):
    """Entropy code for the device-packed AC path.

    hist64: [64, 64] token histograms at base-cluster resolution (the device's
    structured 1980->64 pre-clustering, pack_kernels.ac_base64_map);
    base_map: [NUM_AC_CONTEXTS] u8 that pre-clustering map.

    Returns (full_code, d_table): `full_code` is the EntropyCode over the full
    context space (context map = final clustering composed with base_map) for
    ACGlobal serialization; `d_table` is the factored [9, 64] f32 device
    table — row 0 is the base->cluster map (values < 8, CLUSTERS_LIMIT),
    rows 1..8 the per-cluster entry depth*65536 + canonical code bits (exact
    in f32, < 2^21) per token. The factored form keeps the device's one-hot
    lookup intermediates at [tokens, 8] instead of [tokens, 64]. Mirrors the
    reference's two-stage scheme (enc_frame.cc:768-782 +
    enc_entropy_code.cc:504-514) with the base stage computed arithmetically
    on device.
    """
    code = build_entropy_code(hist64)
    full_map = code.context_map[np.asarray(base_map, np.int64)]
    full = EntropyCode(
        context_map=full_map.astype(np.uint8),
        depths=code.depths,
        bits=code.bits,
        token_depths=code.token_depths,
    )
    return full, _factored_device_table(code)


def _factored_device_table(code: EntropyCode) -> np.ndarray:
    """[9, 64] f32: row 0 = context map (padded to 64 entries), rows 1..8 =
    per-cluster depth*65536 + bits (unused clusters zero)."""
    d = np.zeros((9, 64), np.float32)
    cl = code.context_map.astype(np.int64)
    assert cl.max(initial=0) < 8 and len(cl) <= 64
    d[0, : len(cl)] = cl
    m = code.token_depths.shape[0]
    d[1 : 1 + m] = (
        code.token_depths.astype(np.uint32) << 16
    ) | code.bits.astype(np.uint32)
    return d


def build_dc_device_code(hist45: np.ndarray):
    """DC entropy code + factored [9, 64] device table (context-map entries
    >= num contexts zero) for the device DC-section packer (ops.dc_kernels)."""
    code = build_entropy_code(np.asarray(hist45))
    return code, _factored_device_table(code)


class StaticCodes(
    collections.namedtuple(
        "StaticCodes",
        "ac_codes ac_tables ac_depths dc_codes dc_tables dc_depths",
    )
):
    """Candidate static codes for the one-pass tier.

    *_codes: K-candidate EntropyCode lists (ACGlobal/DCGlobal
    serialization); *_tables: [K, 9, 64] f32 factored device tables
    (pack_kernels.table_lookup); *_depths: [K, 64, 64] i32 emission depth
    grids for the device's integer cost argmin
    (dc_kernels.select_code_table)."""

    __slots__ = ()


def _depth_grid(code):
    g = code.token_depths[code.context_map.astype(np.int64)]
    grid = np.zeros((64, 64), np.int32)
    grid[: g.shape[0]] = g
    return grid


@functools.lru_cache(maxsize=None)
def load_static_codes() -> StaticCodes:
    """Static entropy codes for the one-pass tier (EncoderConfig
    optimize_code=False): the role of the reference's baked
    static_entropy_codes.h:502-971 tables, except that these were trained
    on the repo's test corpus (constants/static_codes.npz, smoothed so that
    every format-possible symbol has a code).

    Token statistics vary across content class and distance, so the tier
    ships K candidate tables per code space and the device picks the
    cheapest per image from the histograms it already computes
    (dc_kernels.select_code_table). The result is shared and read-only."""
    from ..bitstream.sections import dc_context_token_masks
    from ..ops.pack_kernels import ac_base64_map

    path = os.path.join(
        os.path.dirname(__file__), "..", "constants", "static_codes.npz"
    )
    data = np.load(path)
    base_map = ac_base64_map()
    ac_codes, ac_tabs, dc_codes, dc_tabs = [], [], [], []
    for h in data["ac_hists_k"]:
        code, tab = build_ac_device_code(h, base_map)
        ac_codes.append(code)
        ac_tabs.append(tab)
    mask = dc_context_token_masks()
    for h in data["dc_hists_k"]:
        code, tab = build_dc_device_code(h)
        # A possible token with depth 0 would pack 0 bits on the device and
        # corrupt the stream with no error anywhere.
        d = code.depths[code.context_map[: mask.shape[0]].astype(np.int64)]
        if not (d[mask] > 0).all():
            raise ValueError(
                "static DC candidate lacks a code for a format-possible "
                "token: static_codes.npz and dc_context_token_masks disagree"
            )
        dc_codes.append(code)
        dc_tabs.append(tab)
    return StaticCodes(
        ac_codes=ac_codes,
        ac_tables=np.stack(ac_tabs),
        # The AC pick costs against the base-64 histogram, whose context
        # space is exactly the 64 base clusters: grid row c = depths of
        # base context c's cluster.
        ac_depths=np.stack(
            [
                _depth_grid(dataclasses.replace(c, context_map=np.asarray(t[0], np.uint8)))
                for c, t in zip(ac_codes, ac_tabs)
            ]
        ),
        dc_codes=dc_codes,
        dc_tables=np.stack(dc_tabs),
        dc_depths=np.stack([_depth_grid(c) for c in dc_codes]),
    )


def build_entropy_code_from_cluster_histograms(clustered) -> EntropyCode:
    """Build Huffman codes for already-final histograms (no clustering)."""
    clustered = np.asarray(clustered, np.uint64)
    m = clustered.shape[0]
    depths = np.zeros((m, ALPHABET_SIZE), np.uint8)
    bits = np.zeros((m, ALPHABET_SIZE), np.uint16)
    for i in range(m):
        counts = clustered[i]
        length = ALPHABET_SIZE
        while length > 0 and counts[length - 1] == 0:
            length -= 1
        if length:
            depths[i, :length] = create_huffman_depths(counts[:length], 15)
            bits[i, :length] = depths_to_bits(depths[i, :length])
    return EntropyCode(
        context_map=np.arange(m, dtype=np.uint8), depths=depths, bits=bits
    )


def write_entropy_code(code: EntropyCode, writer):
    """WriteEntropyCode (enc_entropy_code.cc:551-554)."""
    write_context_map(code, writer)
    write_prefix_codes(code.depths, code.bits, writer)
