"""Device-side section packing: the compaction kernels (csrc/compact.cu),
the token bit packer (csrc/bitpack.cu) and the torch stages around them.

Counterpart of the JAX package's ops/pack_kernels.py. Program A places each
emission row's tokens into a dense per-group stream (`compact_stream`) and
histograms it (`hist_base64`); program B turns tokens into bit patterns
(`token_data_bits`), packs them into 32-bit words (`bitpack_groups_words`,
whose words are placed by the same compaction kernel) and lays every
group's section words into one buffer (`compact_sections`).
`bitpack_groups_var` is the second bit packer of the JAX package, one
kernel from tokens to words; like there, no encoder path calls it (the
encode keeps `bitpack_groups_words`), its tests and chip_smoke.py do.

Word types: token words (`ctx << 16 | value`, < 2^22) and section words
travel as int32 tensors; section words are 32-bit patterns, so the bit
arithmetic runs in int64 and `u32_to_i32` stores the pattern. The TPU's
one-hot matmul lookups and histograms become integer indexing and a
scatter_add_ with a spare bin (no host sync), and its row-merge and
log-shift left-pack preconditioners for the placement kernel are not
needed: the CUDA kernel finds each output position's row in the prefix sum
and gathers its token.
"""
import numpy as np
import torch

from .. import constants as C
from ._build import I, P, check, load, require, stream_ptr

W = 128  # tokens per emission row / words per section block
M32 = 0xFFFFFFFF


def u32_to_i32(x):
    """int64 tensor holding uint32 values -> int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# Base-64 context map (the structured 1980 -> 64 pre-clustering)
# ---------------------------------------------------------------------------

_NZ_SPLITS = (1, 4, 8)  # nz bucket -> 4 groups
_ZD_Q_MAX = 5  # (nnz+freq) cap -> 12 zd groups with prev bit


def base64_nz(nz_bucket, block_ctx):
    b4 = sum((nz_bucket >= t).to(torch.int32) for t in _NZ_SPLITS)
    return block_ctx * 4 + b4


def ac_base64_map():
    """Full-context map [NUM_AC_CONTEXTS] -> base cluster (u8), the numpy
    twin of base64_nz and of the tokenizer's zero-density contexts."""
    n_nz = C.NUM_BLOCK_CTXS * C.NONZERO_BUCKETS
    m = np.zeros(C.NUM_AC_CONTEXTS, np.uint8)
    ctx = np.arange(C.NUM_AC_CONTEXTS)
    nz = ctx < n_nz
    nz_bucket = ctx[nz] // C.NUM_BLOCK_CTXS
    block = ctx[nz] % C.NUM_BLOCK_CTXS
    b4 = sum((nz_bucket >= t).astype(np.int64) for t in _NZ_SPLITS)
    m[nz] = block * 4 + b4
    rest = ctx[~nz] - n_nz
    block = rest // C.ZERO_DENSITY_CONTEXT_COUNT
    zd = rest % C.ZERO_DENSITY_CONTEXT_COUNT
    q = zd >> 1
    prev = zd & 1
    m[~nz] = 16 + block * 12 + np.minimum(q, _ZD_Q_MAX) * 2 + prev
    return m


# ---------------------------------------------------------------------------
# Row compaction kernel: rows of leading valid lanes -> dense per-group stream
# ---------------------------------------------------------------------------


def compact_rows_plain(tok, cnt, start, cap):
    """Plain torch version of the compact_rows kernel (same arguments)."""
    g, r, w = tok.shape
    lane = torch.arange(w, device=tok.device)
    p = start[..., None] + lane  # [G,R,W] stream positions
    m = (lane < cnt[..., None]) & (p < cap)
    gi = torch.arange(g, device=tok.device)[:, None, None].expand(g, r, w)
    out = torch.zeros((g, cap + W), dtype=torch.int32, device=tok.device)
    out.index_put_((gi[m], p[m]), tok[m])
    return out


def _bind_compact(lib):
    lib.compact_rows_launch.argtypes = [P, P, P, P, I, I, I, P]
    lib.compact_rows_launch.restype = I
    lib.copy_sections_launch.argtypes = [P, P, P, P, I, I, I, P]
    lib.copy_sections_launch.restype = I


class _CompactRows:
    """Kernel wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, tok, cnt, start, cap):
        """tok: [G,R,128] i32 rows; cnt: [G,R] i32 valid leading lanes;
        start: [G,R] i64 exclusive prefix sum of cnt. Returns the stream
        [G, cap+128] i32: row r's tokens at [start, start+cnt), positions
        >= cap dropped, zero from min(total, cap) on."""
        if not tok.is_cuda:
            return compact_rows_plain(tok, cnt, start, cap)
        g, r, _ = tok.shape
        require(tok, torch.int32, (g, r, W), "compact_rows tok")
        require(cnt, torch.int32, (g, r), "compact_rows cnt")
        require(start, torch.int64, (g, r), "compact_rows start")
        if cap % W:
            raise ValueError("compact_rows: cap must be a multiple of 128")
        out = torch.empty((g, cap + W), dtype=torch.int32, device=tok.device)
        lib = load("compact", _bind_compact)
        check(
            lib.compact_rows_launch(
                tok.data_ptr(), cnt.data_ptr(), start.data_ptr(),
                out.data_ptr(), g, r, cap, stream_ptr(tok),
            ),
            "compact_rows",
        )
        self.launches += 1
        return out


compact_rows = _CompactRows()


def compact_stream(rows_tok, rows_cnt, cap, kernels=True):
    """rows_tok: [G, R, 128] i32; rows_cnt: [G, R] i32.

    Returns (stream [G, cap + 128] i32, totals [G] i64): the contract of the
    JAX package's compact_stream and compact_stream_hier. Tokens of row r
    land at [start_r, start_r + cnt_r); positions >= totals are zero;
    over-cap groups are truncated at cap (totals stays exact)."""
    cnt = rows_cnt.to(torch.int32).contiguous()
    ends = torch.cumsum(cnt, dim=1, dtype=torch.int64)
    start = ends - cnt
    tok = rows_tok.contiguous()
    if kernels:
        stream = compact_rows(tok, cnt, start, cap)
    else:
        stream = compact_rows_plain(tok, cnt, start, cap)
    return stream, ends[:, -1]


# ---------------------------------------------------------------------------
# Histograms and per-token bit patterns
# ---------------------------------------------------------------------------


def uint_token_extra(value):
    """Hybrid-uint split (token.h:24-48). value: int64 tensor < 2^16.
    Returns (token, extra bit count, extra bits), int64."""
    vf = torch.clamp_min(value, 16).to(torch.float32)
    n = torch.frexp(vf).exponent.to(torch.int64) - 1  # floor(log2), exact < 2^24
    tok_big = (n << 2) + ((value >> torch.clamp_min(n - 2, 0)) & 3)
    small = value < 16
    tok = torch.where(small, value, tok_big)
    nbits = torch.where(small, 0, n - 2)
    extra = torch.where(small, 0, value & ((1 << nbits) - 1))
    return tok, nbits, extra


def count_bins(bins, valid, n_bins, n_images=1):
    """Exact integer histograms without a host sync. bins: [R, T] int64 in
    [0, n_bins), counted where `valid`; the R rows are n_images images'
    rows in turn. Returns [n_images, n_bins] int64.

    Each row is counted into a row of its own (a scatter_add_ into [R,
    n_bins + 1], invalid slots into the spare last bin, which is dropped),
    so that the atomic adds of a frequent bin spread over R addresses; the
    rows of an image are then summed. The output size never depends on the
    data (a boolean gather or torch.bincount would read a size back to the
    host). Integer sums: exact and the same in any order."""
    r = bins.shape[0]
    idx = torch.where(valid, bins, n_bins)
    out = torch.zeros((r, n_bins + 1), dtype=torch.int64, device=bins.device)
    out.scatter_add_(1, idx, torch.ones_like(idx))
    return out[:, :n_bins].reshape(n_images, r // n_images, n_bins).sum(dim=1)


def hist_base64(stream, totals, n_images=1):
    """[G, cap] token stream -> [n_images, 64, 64] i64 counts of (base ctx,
    token) over each group's first `totals` slots: one histogram an image,
    the G groups being n_images images' groups in turn."""
    g, cap = stream.shape
    valid = torch.arange(cap, device=stream.device)[None, :] < totals[:, None]
    s = stream.to(torch.int64)
    base = (s >> 16) & 63
    tok, _, _ = uint_token_extra(s & 0xFFFF)
    return count_bins(base * 64 + tok, valid, 4096, n_images).reshape(n_images, 64, 64)


def table_lookup(base, tok, d_table):
    """Factored code table lookup: d_table [9, 64] f32 (row 0: base ctx ->
    cluster; rows 1..8: per-cluster depth << 16 | code bits, exact in f32)
    -> depth << 16 | bits per token (int64). base/tok: [G, T]. d_table may
    also be [G, 9, 64], one table a group (the batch's per-image codes):
    the lookup then gathers along the group index too (the contract of the
    JAX package's table_lookup_packed, whose one-hot products were a TPU
    workaround)."""
    d = d_table.to(torch.int64)
    if d.dim() == 2:
        return d[1:][d[0][base], tok]
    gi = torch.arange(d.shape[0], device=d.device)[:, None]
    return d[gi, 1 + d[gi, 0, base], tok]


def token_data_bits(stream, totals, d_table):
    """stream: [G, cap] i32 (base64 << 16 | value); d_table: [9, 64] f32,
    or [G, 9, 64] (one table a group, see table_lookup).

    Returns (data [G, cap] i64, nbits [G, cap] i64): each token's LSB-first
    bit pattern (code bits, then the hybrid-uint extra bits) and length;
    zero past totals."""
    g, cap = stream.shape
    valid = torch.arange(cap, device=stream.device)[None, :] < totals[:, None]
    s = stream.to(torch.int64)
    base = (s >> 16) & 63
    tok, nb_extra, extra = uint_token_extra(s & 0xFFFF)
    packed = table_lookup(base, tok, d_table)
    depth = packed >> 16
    code = packed & 0xFFFF
    data = code | (extra << depth)
    nbits = (depth + nb_extra) * valid
    return torch.where(valid, data, 0), nbits


# ---------------------------------------------------------------------------
# Word-parallel bit packing: segmented OR-scan over words
# ---------------------------------------------------------------------------

VAR_FAN = 32  # entry fan of the JAX package's variable-window packer


def var_safe_words(ow, fan=VAR_FAN):
    """Largest section word count the JAX package's variable-window packer
    handles at this ow. The encoder keeps its ow retry rule against this
    bound so that its bucket choices match the JAX package's."""
    return ow - (fan + 1)


def left_pack(val, keep):
    """Stable left-pack along the last axis: survivors move to the front in
    order; the tail is zero."""
    n = val.shape[-1]
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    idx = torch.where(keep, rank, n)  # dropped values go to a spare slot
    out = torch.zeros(val.shape[:-1] + (n + 1,), dtype=val.dtype, device=val.device)
    out.scatter_(-1, idx, torch.where(keep, val, 0))
    return out[..., :n]


def word_rows(data, nbits, pos, prefix_valid=True):
    """The torch passes of bitpack_groups_words, up to the placement.

    Every output word holds at least one token start, so each word's value
    is a segmented OR over the tokens starting in it (lo parts) plus the
    spill of the token before (hi part): the same doubling OR-scan as the
    JAX package. The words found at each 128-token row's word ends are
    left-packed per row. Returns (rows [G, cap/128, 128] i32, counts
    [G, cap/128] i32: what compact_stream places; spill [G] i64: the hi
    part of the stream's last token, 0 if it spills into no word)."""
    g, cap = data.shape
    if cap % W:
        raise ValueError("bitpack_groups_words: cap must be a multiple of 128")
    dev = data.device
    valid = nbits > 0
    sh = pos & 31
    lo = torch.where(valid, (data << sh) & M32, 0)
    hi = torch.where(valid & (sh > 0), data >> ((32 - sh) & 31), 0)
    if prefix_valid:
        w0 = torch.where(valid, pos >> 5, 1 << 30)
        doublings = (1, 2, 4, 8, 16, 32)
    else:
        w0 = pos >> 5
        doublings = tuple(1 << b for b in range(int(np.ceil(np.log2(max(cap, 2))))))

    def sh_r(a, d, fill):  # bring index t-d to t along the token axis
        return torch.cat([torch.full_like(a[:, :d], fill), a[:, :-d]], dim=1)

    first = w0 != sh_r(w0, 1, -1)
    v = lo | torch.where(first, sh_r(hi, 1, 0), 0)
    for d in doublings:
        same = w0 == sh_r(w0, d, -7)
        v = torch.where(same, v | sh_r(v, d, 0), v)
    nxt = torch.cat([w0[:, 1:], torch.full_like(w0[:, :1], -9)], dim=1)
    e = (valid & (w0 != nxt)) if prefix_valid else (w0 != nxt)
    # The stream's very last token may spill into a word holding no token
    # start; it is ORed onto the placed stream at the end.
    idxs = torch.arange(cap, device=dev)[None, :]
    last_idx = torch.where(valid, idxs, -1).amax(dim=1)
    islast = valid & (idxs == last_idx[:, None])
    spills = islast & ((sh + nbits) > 32)
    spill_v = torch.where(spills, hi, 0).amax(dim=1)

    rows = cap // W
    er = e.reshape(g, rows, W)
    vr = torch.where(e, v, 0).reshape(g, rows, W)
    return u32_to_i32(left_pack(vr, er)), er.sum(dim=-1, dtype=torch.int32), spill_v


def bitpack_groups_words(data, nbits, pos, ow, prefix_valid=True, kernels=True):
    """Vector bit packer (the JAX package's bitpack_groups_words contract).

    data/nbits/pos: [G, cap] int64 per-token LSB-first bit patterns
    (nbits <= 28), widths and absolute bit positions (invalid tokens:
    nbits 0). Returns packed words [G, ow] i32 (uint32 bit patterns, zero
    beyond the section's words).

    The rows of words that word_rows finds are placed into the dense word
    stream by the compact_rows kernel; prefix_valid as in the JAX package
    (False: zero width tokens may interleave, as in the DC layout)."""
    words_rows, counts, spill_v = word_rows(data, nbits, pos, prefix_valid)
    g, dev = data.shape[0], data.device
    words, wtotals = compact_stream(words_rows, counts, ow, kernels)
    words = words[:, :ow].contiguous()
    gi = torch.arange(g, device=dev)
    wi = torch.clamp_max(wtotals, ow - 1)
    cur = words[gi, wi]
    words[gi, wi] = torch.where(spill_v > 0, cur | u32_to_i32(spill_v), cur)
    return words


# ---------------------------------------------------------------------------
# Token bit packer kernel: (data, nbits, pos) -> section words in one pass
# ---------------------------------------------------------------------------


def bitpack_groups_var_plain(data, nbits, pos, ow):
    """Plain torch version of the bitpack kernel (same arguments; int64
    fields are taken too). Tokens occupy disjoint bit ranges, so adding
    their word parts in int64 equals ORing them."""
    g, cap = data.shape
    data = data.to(torch.int64) & M32  # the uint32 pattern of an int32 field
    nbits, pos = nbits.to(torch.int64), pos.to(torch.int64)
    valid = nbits > 0
    sh = pos & 31
    w = pos >> 5
    lo = torch.where(valid, (data << sh) & M32, 0)
    hi = torch.where(valid & (sh + nbits > 32), data >> ((32 - sh) & 31), 0)
    # Words at or beyond ow are dropped: they land in the spare column.
    out = torch.zeros((g, ow + 1), dtype=torch.int64, device=data.device)
    out.scatter_add_(1, torch.clamp_max(w, ow), lo)
    out.scatter_add_(1, torch.clamp_max(w + 1, ow), hi)
    return u32_to_i32(out[:, :ow])


def _bind_bitpack(lib):
    lib.bitpack_launch.argtypes = [P, P, P, P, I, I, I, P]
    lib.bitpack_launch.restype = I


class _BitpackVar:
    """Kernel wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, data, nbits, pos, ow):
        """data/nbits/pos: [G, cap] int32 per-token LSB-first bit patterns
        (the uint32 pattern; data < 2^nbits, nbits <= 28), widths and bit
        positions; tokens of width 0 are no-ops and may sit anywhere.
        Returns the packed words [G, ow] i32 (uint32 bit patterns): the OR
        of every token at its position, zero elsewhere; words at or beyond
        ow are dropped.

        Precondition, the JAX packer's (jxl_tiny_tpu/ops/pack_kernels.py:
        601-610, whose fused entries read one position each, `:833`):
        inside a group pos is the exclusive prefix sum of nbits, starting
        at 0. The kernel reads one position per run of tokens and relies on
        it; the plain version does not.

        This is the contract of the JAX package's bitpack_groups_var for
        sections of at most var_safe_words(ow) words, which is all its
        callers may pass; beyond that the JAX kernel mis-places entries,
        while this one packs up to ow words and drops what lies beyond.
        CPU tensors take the plain version; CUDA tensors must be int32."""
        if not data.is_cuda:
            return bitpack_groups_var_plain(data, nbits, pos, ow)
        g, cap = data.shape
        require(data, torch.int32, (g, cap), "bitpack_groups_var data")
        require(nbits, torch.int32, (g, cap), "bitpack_groups_var nbits")
        require(pos, torch.int32, (g, cap), "bitpack_groups_var pos")
        out = torch.empty((g, ow), dtype=torch.int32, device=data.device)
        lib = load("bitpack", _bind_bitpack)
        check(
            lib.bitpack_launch(
                data.data_ptr(), nbits.data_ptr(), pos.data_ptr(),
                out.data_ptr(), g, cap, ow, stream_ptr(data),
            ),
            "bitpack_groups_var",
        )
        self.launches += 1
        return out


bitpack_groups_var = _BitpackVar()


# ---------------------------------------------------------------------------
# Section copy kernel: [G, ow] section words -> one aligned buffer
# ---------------------------------------------------------------------------


def copy_sections_plain(packed, nblk, offs, wcap):
    """Plain torch version of the copy_sections kernel (same arguments)."""
    g, ow = packed.shape
    idx = torch.arange(ow, device=packed.device)[None, :]
    dst = offs[:, None] + idx
    m = (idx < nblk[:, None] * W) & (dst < wcap)
    buf = torch.zeros((wcap,), dtype=torch.int32, device=packed.device)
    buf[dst[m]] = packed[m]
    return buf


class _CopySections:
    """Kernel wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, packed, nblk, offs, wcap):
        """packed: [G, ow] i32 section words; nblk/offs: [G] i64 128-word
        block counts and destination word offsets (the exclusive prefix sum
        of nblk * 128). Returns [wcap] i32: each group's blocks at its
        offset, zero elsewhere. The kernel moves whole 128-word blocks, so
        for a CUDA tensor ow and wcap must be multiples of 128."""
        if not packed.is_cuda:
            return copy_sections_plain(packed, nblk, offs, wcap)
        g, ow = packed.shape
        require(packed, torch.int32, (g, ow), "copy_sections packed")
        require(nblk, torch.int64, (g,), "copy_sections nblk")
        require(offs, torch.int64, (g,), "copy_sections offs")
        if ow % W or wcap % W:
            raise ValueError("copy_sections: ow and wcap must be multiples of 128")
        if packed.data_ptr() % 16:
            raise ValueError("copy_sections packed: expected 16-byte alignment")
        buf = torch.empty((wcap,), dtype=torch.int32, device=packed.device)
        lib = load("compact", _bind_compact)
        check(
            lib.copy_sections_launch(
                packed.data_ptr(), nblk.data_ptr(), offs.data_ptr(),
                buf.data_ptr(), g, ow, wcap, stream_ptr(packed),
            ),
            "copy_sections",
        )
        self.launches += 1
        return buf


copy_sections = _CopySections()


def sections_wcap(n_sections, ow):
    """Words of a compacted section buffer for n_sections sections of at
    most ow words each: the power of two above n_sections * ow, at most 2M
    (the JAX package's rule; on a mesh, n_sections is one rank's)."""
    return min(1 << int(n_sections * ow).bit_length(), 2 * 1024 * 1024)


def compact_sections(packed, bits, wcap, kernels=True):
    """packed: [G, ow] i32; bits: [G] section bit lengths.

    Lays each group's ceil(bits/32) words at a 128-word-aligned offset of
    one [wcap] buffer. Returns (buffer [wcap] i32, word offsets [G] i64)."""
    nblk = (bits.to(torch.int64) + (32 * W - 1)) // (32 * W)
    ends = torch.cumsum(nblk * W, dim=0)
    offs = ends - nblk * W
    fn = copy_sections if kernels else copy_sections_plain
    return fn(packed.contiguous(), nblk, offs, wcap), offs


def pack_ac_sections(stream, totals, d_table, ow, wcap, compact=True, kernels=True):
    """Program B for the AC sections: stream [G, cap] i32 + factored code
    table -> dict(words, bits [G], word_offs [G]); words is [wcap] i32, or
    the uncompacted [G, ow] rows when compact=False (the overflow path)."""
    data, nbits = token_data_bits(stream, totals, d_table)
    ends = torch.cumsum(nbits, dim=1)
    pos = ends - nbits
    bits = ends[:, -1]
    packed = bitpack_groups_words(data, nbits, pos, ow, kernels=kernels)
    if not compact:
        return dict(words=packed, bits=bits, word_offs=torch.zeros_like(bits))
    words, offs = compact_sections(packed, bits, wcap, kernels)
    return dict(words=words, bits=bits, word_offs=offs)
