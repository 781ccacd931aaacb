"""Per-coefficient tokenization: CUDA kernel (csrc/tokenize.cu) and its plain
torch version.

Counterpart of the JAX package's ops/tokenize_kernel.py (`_tok_kernel`,
reached through `tokenize_cells`). Per 128-coefficient emission row: the
inclusive prefix count of nonzeros, `nz_left`, the previous-nonzero bit,
the base-64 zero-density context with the one-threshold NNZ shortcut, the
covered=2 slot shift and `ctx << 16 | value` packing; lane 0 holds the
nzeros token. Integer arithmetic only: kernel, plain version and the JAX
kernel agree exactly.
"""
import torch

from ._build import I, P, check, load, require, stream_ptr


def pack_row_meta(covered, nzeros_total, block_ctx, nzero_ctx, prev_init, first):
    """Per-cell scalars -> one i32 word (the JAX package's layout)."""
    return (
        ((covered - 1) & 1)
        | (nzeros_total << 1)
        | (block_ctx << 8)
        | (nzero_ctx << 12)
        | (prev_init << 18)
        | (first.to(torch.int32) << 19)
    )


def tokenize_rows_plain(x, meta, freq_tab, nnz_thresh0):
    """x: [n,128] i32 zig-zag coefficients; meta: [n] i32 packed row
    scalars; freq_tab: [2,128] i32. Returns tokens [n,128] i32."""
    lane = torch.arange(128, device=x.device)[None, :]
    meta = meta[:, None]
    covered = (meta & 1) + 1
    nztot = (meta >> 1) & 127
    block_ctx = (meta >> 8) & 15
    nzero_ctx = (meta >> 12) & 63
    prev_init = (meta >> 18) & 1
    first = (meta >> 19) & 1
    cov2 = covered == 2

    in_range = (lane >= covered) & (lane < covered * 64)
    nzv = ((x != 0) & in_range).to(torch.int32)
    cum = torch.cumsum(nzv, dim=1, dtype=torch.int32)
    nz_left = nztot - cum + nzv
    prev_nz = torch.cat([torch.zeros_like(nzv[:, :1]), nzv[:, :-1]], dim=1)
    prev = torch.where(lane == covered, prev_init, prev_nz)
    nzl_shift = torch.where(cov2, (nz_left + 1) >> 1, nz_left)
    freq_sel = torch.where(cov2, freq_tab[1][None, :], freq_tab[0][None, :])
    # The base-64 q cap (5) saturates as soon as any NNZ step fires (every
    # step delta exceeds 5; EncoderTables checks it), so one threshold test
    # replaces the step function.
    q = torch.where(nzl_shift >= nnz_thresh0, 5, torch.clamp_max(freq_sel, 5))
    coeff_ctx = 16 + block_ctx * 12 + q * 2 + prev
    tok_valid = (in_range & (nz_left > 0) & (first > 0)).to(torch.int32)
    coeff_val = torch.where(x >= 0, 2 * x, -2 * x - 1)

    def shsel(a):  # covered=2 reads lane k+1, filling 0 past the row
        nxt = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        return torch.where(cov2, nxt, a)

    ctx_g = shsel(coeff_ctx)
    val_g = shsel(coeff_val)
    valid_g = shsel(tok_valid) * (lane != 0)
    packed = torch.where(valid_g > 0, (ctx_g << 16) | val_g, 0)
    nz_token = (nzero_ctx << 16) | nztot
    return torch.where(lane == 0, nz_token, packed).to(torch.int32)


def _bind(lib):
    lib.tokenize_launch.argtypes = [P, P, P, P, I, I, P]
    lib.tokenize_launch.restype = I


class _Tokenize:
    """Kernel wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, meta, tables):
        """x: [n,128] i32; meta: [n] i32 -> tokens [n,128] i32."""
        if not x.is_cuda:
            return tokenize_rows_plain(x, meta, tables.freq_tab, tables.nnz_thresh0)
        n = x.shape[0]
        require(x, torch.int32, (n, 128), "tokenize x")
        require(meta, torch.int32, (n,), "tokenize meta")
        out = torch.empty((n, 128), dtype=torch.int32, device=x.device)
        lib = load("tokenize", _bind)
        check(
            lib.tokenize_launch(
                x.data_ptr(), meta.data_ptr(), tables.freq_tab.data_ptr(),
                out.data_ptr(), n, tables.nnz_thresh0, stream_ptr(x),
            ),
            "tokenize_rows",
        )
        self.launches += 1
        return out


tokenize_rows = _Tokenize()


def tokenize_cells(ordered, covered, nzeros_total, block_ctx, nzero_ctx,
                   prev_init, first, tables, kernels=True):
    """ordered: [..., 128] i32 zig-zag coefficients; the rest: [...] per
    cell. Returns tokens [..., 128] i32 (lane 0 = nzeros token, lanes >= 1
    = coefficient tokens)."""
    shp = ordered.shape
    meta = pack_row_meta(
        covered.to(torch.int32), nzeros_total.to(torch.int32),
        block_ctx.to(torch.int32), nzero_ctx.to(torch.int32),
        prev_init.to(torch.int32), first,
    ).reshape(-1).contiguous()
    x = ordered.to(torch.int32).reshape(-1, 128)
    if kernels:
        out = tokenize_rows(x, meta, tables)
    else:
        out = tokenize_rows_plain(x, meta, tables.freq_tab, tables.nnz_thresh0)
    return out.reshape(shp)
