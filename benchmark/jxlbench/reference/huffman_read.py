"""Reading Brotli-style prefix-code bundles (inverse of entropy_write).

Implements the subset of histogram decoding the tiny encoder emits:
use_prefix_code=1, hybrid-uint config (4,2,0), simple trees, and complex trees
with the static code-length code. Used by the verification decoder to read
both our own streams and streams produced by the reference encoder.

Frozen copy for the benchmark of jxl_tiny_tpu_torch/decode/huffman_read.py
(lookup tables as lists, imports at the top) at commit 8ebce9c.
"""
import numpy as np

from .codes import uint_decode_token
from .constants import ALPHABET_SIZE

# Static Huffman code over code-length code lengths: value -> (nbits, symbol).
# Mirrors enc_entropy_code.cc:22-37; decode by peeking 4 bits.
_STORAGE_ORDER = [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _read_code_length_code_length(reader):
    """Decode one symbol of the static code: 00->0, 01->3, 10->4, 110->2,
    1110->1, 1111->5."""
    if reader.read(1) == 0:
        return 0 if reader.read(1) == 0 else 3
    if reader.read(1) == 0:
        return 4
    if reader.read(1) == 0:
        return 2
    return 1 if reader.read(1) == 0 else 5


class PrefixDecoder:
    """Decode table for one prefix code (max depth 15)."""

    def __init__(self, depths, bits):
        self.depths = np.asarray(depths, np.uint8)
        max_d = int(self.depths.max()) if self.depths.size else 0
        self.max_depth = max_d
        if max_d == 0:
            # 0-bit code: single symbol.
            used = np.nonzero(self.depths)[0]
            self.single = int(used[0]) if used.size else 0
            self.lut = None
            return
        self.single = None
        lut_sym = np.zeros(1 << max_d, np.int32)
        lut_len = np.zeros(1 << max_d, np.int32)
        for sym, d in enumerate(self.depths):
            d = int(d)
            if d == 0:
                continue
            code = int(bits[sym])  # already bit-reversed (LSB-first)
            step = 1 << d
            for fill in range(code, 1 << max_d, step):
                lut_sym[fill] = sym
                lut_len[fill] = d
        # Python lists: one symbol is two list reads, not two numpy
        # scalar conversions.
        self.lut_sym = lut_sym.tolist()
        self.lut_len = lut_len.tolist()

    def read_symbol(self, reader) -> int:
        if self.single is not None:
            return self.single
        window = reader.peek(self.max_depth)
        length = self.lut_len[window]
        if length == 0:
            # Window not covered by any codeword (incomplete code from a
            # corrupt stream) — without this check the caller would spin
            # forever consuming 0 bits.
            from .errors import DecodeError

            raise DecodeError("invalid prefix-code word")
        sym = self.lut_sym[window]
        reader.skip(length)
        return sym


def read_prefix_code(reader, alphabet_size) -> PrefixDecoder:
    """Inverse of WritePrefixCode for a known alphabet size (> 1)."""
    max_bits = 0
    c = alphabet_size - 1
    while c:
        c >>= 1
        max_bits += 1
    sel = reader.read(2)
    depths = np.zeros(ALPHABET_SIZE, np.uint8)
    if sel == 1:
        # Simple tree.
        nsym = reader.read(2) + 1
        syms = [reader.read(max_bits) for _ in range(nsym)]
        if nsym == 1:
            depths[syms[0]] = 0  # 0-bit code
            dec = PrefixDecoder(depths, np.zeros(ALPHABET_SIZE, np.uint16))
            dec.single = syms[0]
            return dec
        if nsym == 2:
            depths[syms[0]] = depths[syms[1]] = 1
        elif nsym == 3:
            depths[syms[0]] = 1
            depths[syms[1]] = depths[syms[2]] = 2
        else:
            tree_select = reader.read(1)
            if tree_select:
                depths[syms[0]] = 1
                depths[syms[1]] = 2
                depths[syms[2]] = depths[syms[3]] = 3
            else:
                for s in syms:
                    depths[s] = 2
        from .codes import depths_to_bits

        return PrefixDecoder(depths, depths_to_bits(depths))
    # Complex tree: sel is skip_some (0, 2 or 3).
    skip_some = sel
    code_lengths = np.zeros(18, np.uint8)
    space = 32
    num_codes = 0
    i = skip_some
    while i < 18 and space > 0:
        l = _read_code_length_code_length(reader)
        code_lengths[_STORAGE_ORDER[i]] = l
        if l:
            space -= 32 >> l
            num_codes += 1
        i += 1
    from .codes import depths_to_bits

    if space != 0 and num_codes != 1:
        from .errors import DecodeError

        raise DecodeError("invalid code-length code (not complete)")
    len_decoder = PrefixDecoder(code_lengths, depths_to_bits(code_lengths))
    if num_codes == 1:
        only = int(np.nonzero(code_lengths)[0][0])
        len_decoder.single = only
        len_decoder.max_depth = 0

    # Read symbol lengths with Brotli repeat semantics.
    space = 1 << 15
    symbol = 0
    prev_nonzero_len = 8
    repeat = 0
    repeat_len = 0
    while symbol < alphabet_size and space > 0:
        l = len_decoder.read_symbol(reader)
        if l < 16:
            repeat = 0
            depths[symbol] = l
            symbol += 1
            if l:
                prev_nonzero_len = l
                space -= (1 << 15) >> l
        else:
            extra_bits = 2 if l == 16 else 3
            new_len = prev_nonzero_len if l == 16 else 0
            if repeat and repeat_len == new_len:
                old = repeat
                repeat = ((repeat - 2) << extra_bits) + reader.read(extra_bits) + 3
                extra_count = repeat - old
            else:
                repeat = reader.read(extra_bits) + 3
                extra_count = repeat
            repeat_len = new_len
            for _ in range(extra_count):
                if symbol >= alphabet_size:
                    break
                depths[symbol] = new_len
                symbol += 1
                if new_len:
                    space -= (1 << 15) >> new_len
    if space != 0:
        from .errors import DecodeError

        raise DecodeError("prefix code not complete (corrupt histogram)")
    return PrefixDecoder(depths, depths_to_bits(depths))


def read_prefix_code_bundle(reader, num_codes, alphabet_sizes=None):
    """Inverse of WritePrefixCodes: returns list of PrefixDecoder."""
    use_prefix = reader.read(1)
    assert use_prefix == 1, "ANS streams not supported by this subset decoder"
    for _ in range(num_codes):
        se = reader.read(4)
        msb = reader.read(3)
        lsb = reader.read(2)
        assert (se, msb, lsb) == (4, 2, 0), "unexpected hybrid-uint config"
    sizes = []
    for _ in range(num_codes):
        if reader.read(1) == 0:
            sizes.append(1)
        else:
            nbits = reader.read(4)
            sizes.append((1 << nbits) + reader.read(nbits) + 1)
    decoders = []
    for c in range(num_codes):
        if sizes[c] == 1:
            d = PrefixDecoder(np.zeros(ALPHABET_SIZE, np.uint8), None)
            d.single = 0
            decoders.append(d)
        else:
            decoders.append(read_prefix_code(reader, sizes[c]))
    return decoders


def read_context_map(reader, num_contexts):
    """Inverse of WriteContextMap: returns (context_map, num_clusters)."""
    is_simple = reader.read(1)
    if is_simple:
        ctx_bits = reader.read(2)
        if ctx_bits == 0:
            return np.zeros(num_contexts, np.uint8), 1
        cm = np.array(
            [reader.read(ctx_bits) for _ in range(num_contexts)], np.uint8
        )
        return cm, int(cm.max()) + 1
    use_mtf = reader.read(1)
    assert use_mtf == 0, "MTF context maps not emitted by the tiny subset"
    lz77 = reader.read(1)
    assert lz77 == 0
    decoders = read_prefix_code_bundle(reader, 1)
    from .codes import uint_decode_token

    cm = np.zeros(num_contexts, np.uint8)
    for i in range(num_contexts):
        tok = decoders[0].read_symbol(reader)
        cm[i] = uint_decode_token(tok, reader)
    return cm, int(cm.max()) + 1


def read_histograms(reader, num_contexts):
    """Read lz77 flag + context map + prefix codes for a token stream."""
    lz77 = reader.read(1)
    assert lz77 == 0, "lz77 streams not supported"
    if num_contexts == 1:
        cm = np.zeros(1, np.uint8)
        nclusters = 1
    else:
        cm, nclusters = read_context_map(reader, num_contexts)
    decoders = read_prefix_code_bundle(reader, nclusters)
    return cm, decoders


class TokenReader:
    def __init__(self, reader, context_map, decoders):
        self.reader = reader
        self.context_map = context_map
        self.decoders = decoders

    def read(self, ctx) -> int:
        dec = self.decoders[int(self.context_map[ctx])]
        tok = dec.read_symbol(self.reader)
        return uint_decode_token(tok, self.reader)
