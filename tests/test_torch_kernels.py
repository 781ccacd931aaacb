"""Kernel modules of the PyTorch port against the JAX package.

Each plain torch version (what a kernel wrapper runs on a CPU tensor) gets
the same numpy-made inputs as its JAX twin; the Pallas kernels run in
interpret mode on the CPU, as in the JAX package's own tests. Tolerances:
integer outputs exact; float outputs (AQ qf / masking, the 16x8 / 8x16
DCTs) rtol 1e-5, atol 1e-6, since torch's and XLA's transcendental
functions (exp2, log2) round differently and their matrix products
accumulate in different orders; raw_qf decisions exact. The strategy
estimates are 64- and 128-term float sums whose order differs between the
packages (and XLA contracts a*b+c into FMA): rtol 5e-5, the figure the JAX
package's own kernel-against-twin test uses. The quad decisions and the
quant-field adjustment, fed the JAX package's estimates, are exact.

Tests marked `gpu` compare each CUDA kernel with its plain version on the
card (exact); they skip on a host without one. The machine with the card
has no JAX, so this module imports JAX only inside the CPU tests, and the
card runs it without the JAX-importing conftest:
    python -m pytest tests/test_torch_kernels.py -q -m gpu --noconftest"""
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch.common import compute_distance_params
from jxl_tiny_tpu_torch.entropy.entropy_write import build_ac_device_code
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import aq_kernel as AQ
from jxl_tiny_tpu_torch.ops import dc_kernels as DK
from jxl_tiny_tpu_torch.ops import pack_kernels as PK
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.ops import quantize_kernel as QK
from jxl_tiny_tpu_torch.ops import strategy_kernel as SK
from jxl_tiny_tpu_torch.ops import tokenize_kernel as TK
from jxl_tiny_tpu_torch.ops import dct as DCT
from jxl_tiny_tpu_torch.tables import numpy_tables, tables_from_numpy

NP_TABLES = numpy_tables()
TABLES = tables_from_numpy(NP_TABLES, "cpu")
TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")


def u32(t):
    """Port int32 word tensor -> numpy uint32 (same bits)."""
    return t.contiguous().numpy().view(np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def jx():
    """The JAX package's functions under test (imported per test: the
    machine with the card has no JAX)."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    from jxl_tiny_tpu.ops import dc_kernels, dct_jax, pack_kernels, pipeline_jax
    from jxl_tiny_tpu.ops import strategy_kernel
    from jxl_tiny_tpu.ops.aq_kernel import adaptive_quant_field_kernel
    from jxl_tiny_tpu.ops.quantize_kernel import quantize_cells
    from jxl_tiny_tpu.ops.tokenize_kernel import tokenize_cells

    return SimpleNamespace(
        jnp=jnp, DK=dc_kernels, PK=pack_kernels, PJ=pipeline_jax,
        SK=strategy_kernel, DCT=dct_jax,
        aq=adaptive_quant_field_kernel, quantize=quantize_cells,
        tokenize=tokenize_cells,
    )


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded)
# ---------------------------------------------------------------------------


def _xyb_groups():
    """[2,3,256,256] XYB: photo256 and a seeded smooth-plus-noise group."""
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    synth = np.stack([
        0.5 + 0.4 * np.sin(xx * 0.05) * np.cos(yy * 0.03),
        0.4 + 0.3 * np.cos((xx + yy) * 0.02),
        0.3 + 0.2 * np.sin(yy * 0.04),
    ]) + rng.randn(3, 256, 256).astype(np.float32) * 0.02
    photo = read_pfm(os.path.join(TESTDATA, "photo256.pfm"))
    rgb = np.stack([photo, np.clip(synth, 0, 1).astype(np.float32)])
    return PL.to_xyb(torch.from_numpy(rgb)).numpy()


def _quant_inputs(seed=2, g=2):
    rng = np.random.RandomState(seed)
    amp = np.where(np.arange(64) == 0, 0.3, 0.0015).astype(np.float32)
    coef8 = (rng.randn(g, 3, 32, 32, 64) * amp).astype(np.float32)
    amp16 = np.where(np.arange(128) < 2, 0.3, 0.0015).astype(np.float32)
    coef_v = (rng.randn(g, 3, 16, 32, 128) * amp16).astype(np.float32)
    coef_h = (rng.randn(g, 3, 32, 16, 128) * amp16).astype(np.float32)
    strategy = rng.randint(0, 3, size=(g, 32, 32)).astype(np.int32)
    raw_qf = rng.randint(1, 60, size=(g, 32, 32)).astype(np.int32)
    ytox = rng.randint(-20, 21, size=(g, 4, 4))
    ytob = rng.randint(-20, 21, size=(g, 4, 4))
    icf = np.float32(1.0 / 84)
    fac_x = (np.repeat(np.repeat(ytox, 8, 1), 8, 2).astype(np.float32) * icf)
    fac_b = (1.0 + np.repeat(np.repeat(ytob, 8, 1), 8, 2).astype(np.float32) * icf)
    return [coef8, coef_v, coef_h, strategy, raw_qf,
            fac_x.astype(np.float32), fac_b.astype(np.float32)]


def _token_rows(seed=3, g=2):
    """Sparse zig-zag rows [g,32,32,3,128] and consistent per-cell maps."""
    rng = np.random.RandomState(seed)
    dens = rng.rand(g, 32, 32, 3, 1) ** 3
    vals = rng.randint(-300, 301, size=(g, 32, 32, 3, 128))
    ordered = np.where(rng.rand(g, 32, 32, 3, 128) < dens, vals, 0).astype(np.int32)
    covered = rng.randint(1, 3, size=(g, 32, 32, 3)).astype(np.int32)
    lane = np.arange(128)
    in_range = (lane >= covered[..., None]) & (lane < covered[..., None] * 64)
    nzeros = ((ordered != 0) & in_range).sum(-1).astype(np.int32)
    block_ctx = rng.randint(0, 4, size=covered.shape).astype(np.int32)
    nzero_ctx = rng.randint(0, 16, size=covered.shape).astype(np.int32)
    prev_init = rng.randint(0, 2, size=covered.shape).astype(np.int32)
    first = rng.rand(*covered.shape) < 0.8
    return [ordered, covered, nzeros, block_ctx, nzero_ctx, prev_init, first]


def _rows(seed, g, over_cap=False, rows=1024):
    """Emission rows [g, rows, 128] and counts: empty, thin and fat rows
    (> 32 tokens, the hierarchical kernel's third class)."""
    rng = np.random.RandomState(seed)
    cnt = rng.poisson(4.0, size=(g, rows)).clip(0, 128).astype(np.int32)
    cnt[rng.rand(g, rows) < 0.4] = 0
    fat = rng.rand(g, rows) < 0.05
    cnt[fat] = rng.randint(33, 129, size=int(fat.sum()))
    if over_cap:
        cnt[-1, :300] = 128  # the last group far over a 32768 cap
    tok = rng.randint(1, 1 << 22, size=(g, rows, 128)).astype(np.int32)
    return tok, cnt


ROW_CASES = ["zero_runs", "all_full", "empty_group", "tile_multiple", "over_cap",
             "fat_few_groups"]


def _rows_case(case):
    """(tok, cnt, cap) for the inputs the output-driven placement kernel is
    sensitive to; its tiles are 1024 positions. zero_runs: hundreds of empty
    rows between the rows that hold tokens; all_full: every row at 128 and
    the total equal to the cap; empty_group: a group with total 0 between
    two others; tile_multiple: totals of exactly 1024, 2048 and 3072;
    over_cap: the last group beyond the cap; fat_few_groups: four groups of
    rows at 100-128 words (program B's DC word rows)."""
    rng = np.random.RandomState(21 + ROW_CASES.index(case))
    g, rows, cap = 3, 256, 4096
    cnt = rng.poisson(4.0, size=(g, rows)).clip(0, 128).astype(np.int32)
    cnt[rng.rand(g, rows) < 0.4] = 0
    if case == "zero_runs":
        cnt[:, 3:200] = 0
        cnt[:, 206:255] = 0
        cnt[1, 200:206] = [128, 1, 0, 77, 128, 33]
        cnt[2, :255] = 0  # only the last row holds tokens
        cnt[2, 255] = 90
    elif case == "all_full":
        rows = 32
        cnt = np.full((g, rows), 128, np.int32)
    elif case == "empty_group":
        cnt[1] = 0
    elif case == "tile_multiple":
        cnt[:, ::5] = 128  # enough tokens for the largest total
        for k in range(g):
            want = 1024 * (k + 1)
            ends = np.cumsum(cnt[k])
            last = int(np.searchsorted(ends, want, side="right"))
            cnt[k, last:] = 0
            cnt[k, last] = want - (ends[last - 1] if last else 0)
            assert 0 <= cnt[k, last] <= 128 and cnt[k].sum() == want
    elif case == "over_cap":
        cnt[-1, :40] = 128
    elif case == "fat_few_groups":
        g, rows, cap = 4, 64, 8192
        cnt = rng.randint(100, 129, size=(g, rows)).astype(np.int32)
        cnt[rng.rand(g, rows) < 0.2] = 0
        cnt[3, 10:] = 0  # a short group among long ones
    tok = rng.randint(1, 1 << 22, size=(g, rows, 128)).astype(np.int32)
    return tok, cnt, cap


SECTION_CASES = ["first_empty", "middle_empty", "last_empty", "fills_ow", "one_group"]


def _sections_case(case):
    """(packed u32 [g, ow], bits, wcap) for compact_sections."""
    rng = np.random.RandomState(31 + SECTION_CASES.index(case))
    g, ow, wcap = (1 if case == "one_group" else 5), 1024, 8192
    bits = rng.randint(1, 32 * (ow - 40), size=g).astype(np.int32)
    if case.endswith("_empty"):
        bits[{"first_empty": 0, "middle_empty": 2, "last_empty": g - 1}[case]] = 0
    elif case == "fills_ow":
        bits[1] = 32 * ow  # every word of the row, and its last block whole
        bits[3] = 32 * ow - 31  # the last word holds one bit
    packed = rng.randint(0, 1 << 32, size=(g, ow), dtype=np.uint64).astype(np.uint32)
    packed[np.arange(ow)[None, :] >= ((bits + 31) // 32)[:, None]] = 0
    return packed, bits, wcap


def _dc_maps(seed=4):
    rng = np.random.RandomState(seed)
    pd = DK.PD
    qdc = rng.randint(-300, 300, size=(1, 3, pd, pd)).astype(np.int32)
    qdc[:, :, :, :] += (np.arange(pd)[None, None, None, :] // 8)  # smooth trend
    raw_qf = rng.randint(1, 40, size=(1, pd, pd)).astype(np.int32)
    strategy = np.zeros((1, pd, pd), np.int32)
    is_first = rng.rand(1, pd, pd) < 0.9
    ytox = rng.randint(-30, 30, size=(1, 32, 32)).astype(np.int32)
    ytob = rng.randint(-30, 30, size=(1, 32, 32)).astype(np.int32)
    ydb, xdb = 150, 203
    geo = [np.array([v], np.int32) for v in (
        ydb, xdb, -(-ydb * 8 // 64), -(-xdb * 8 // 64),
        int(ydb * xdb - 1).bit_length())]
    return [qdc, raw_qf, strategy, is_first, ytox, ytob], geo


def _estimate_inputs(seed=3, g=2, realistic=True):
    """Random coefficient sets and cell maps for the strategy estimates, in
    the argument order of estimate_partials. `realistic` scales each
    coefficient by its quant weight so that the scaled values are of order
    one, as an encoder's are; otherwise the coefficients are unit normals
    (the JAX package's own kernel test), whose scaled values run into the
    thousands: there the info-loss partials sum squared rounding residues
    of numbers whose last bit is ~1e-3, and only the combined estimates,
    which the entropy terms dominate, are comparable."""
    rng = np.random.RandomState(seed)
    f = np.float32
    qm8, qm16 = NP_TABLES["qm8"], NP_TABLES["qm16"]
    coef8 = rng.randn(g, 3, 32, 32, 64).astype(f)
    coef_v = rng.randn(g, 3, 16, 32, 128).astype(f)
    coef_h = rng.randn(g, 3, 32, 16, 128).astype(f)
    if realistic:
        # The low-frequency weights are zero (those positions cost nothing).
        w8 = f(1.5) / np.where(qm8 == 0, f(1.5), qm8)[None, :, None, None, :]
        w16 = f(1.5) / np.where(qm16 == 0, f(1.5), qm16)[None, :, None, None, :]
        coef8, coef_v, coef_h = coef8 * w8, coef_v * w16, coef_h * w16
    qf = np.abs(rng.randn(g, 32, 32)).astype(f)
    masking = np.abs(rng.randn(g, 32, 32)).astype(f)
    fac = np.stack([rng.randn(g, 32, 32).astype(f) * f(0.1),
                    f(1.0) + rng.randn(g, 32, 32).astype(f) * f(0.1)], axis=1)
    return [
        coef8, coef_v, coef_h,
        qf, np.maximum(qf[:, ::2], qf[:, 1::2]), np.maximum(qf[:, :, ::2], qf[:, :, 1::2]),
        masking, np.maximum(masking[:, ::2], masking[:, 1::2]),
        np.maximum(masking[:, :, ::2], masking[:, :, 1::2]),
        fac, np.ascontiguousarray(fac[:, :, ::2]), np.ascontiguousarray(fac[:, :, :, ::2]),
        qm8, qm16,
    ]


def _var_token_fields(case):
    """The three inputs of the JAX package's variable-window packer tests:
    a section filled up to var_safe_words(ow), interleaved zero-width
    entries with whole zero runs, and maximal 28-bit widths. Returns
    (data u32, nbits i32, pos i32, ow), one group each."""
    if case == "safe_fill":
        rng = np.random.RandomState(1)
        cap, ow = 4096, 512
        nbits = rng.randint(10, 28, size=(1, cap)).astype(np.int32)
        nbits[0, np.cumsum(nbits[0]) > 32 * PK.var_safe_words(ow)] = 0
        draw = rng.randint(0, 1 << 30, size=(1, cap))
    else:
        rng = np.random.RandomState(12)
        cap = ow = 4096
        nbits = rng.randint(0, 29, size=(2, cap)).astype(np.int32)
        nbits[0, ::3] = 0
        nbits[0, 64:192] = 0
        nbits[1, :64] = 28
        nbits[:, -11:] = 0
        draw = rng.randint(0, 1 << 30, size=(2, cap))
        k = {"zero_runs": 0, "max_widths": 1}[case]
        nbits, draw = nbits[k: k + 1], draw[k: k + 1]
    data = (draw & ((1 << np.maximum(nbits, 1)) - 1)).astype(np.uint32)
    data[nbits == 0] = 0
    pos = (np.cumsum(nbits, axis=1) - nbits).astype(np.int32)
    return data, nbits, pos, ow


BITPACK_EDGE_CASES = ["offset31_28bit", "zero_width_runs", "ow_cut"]


def _bitpack_edge_fields(case):
    """Token fields at the edges of csrc/bitpack.cu's run merge (runs of 8
    tokens, chunks of 1,024): a 28-bit token at bit offset 31, at the start
    of the stream and at the first token of the second chunk;
    zero widths over a whole run, a whole chunk and the tail, in two
    groups; and an ow whose word boundary falls inside a run. Returns
    (data u32, nbits i32, pos i32, ow) as _var_token_fields."""
    rng = np.random.RandomState(71 + BITPACK_EDGE_CASES.index(case))
    if case == "ow_cut":
        data, nbits, pos, _ = _var_token_fields("max_widths")
        p = pos[0]
        t = next(t for t in range(2048, 4000, 8) if p[t] < 32 * (p[t + 4] // 32) < p[t + 8])
        return data, nbits, pos, int(p[t + 4] // 32)
    if case == "offset31_28bit":
        g, cap, ow = 1, 2048, 1024
        nbits = rng.randint(1, 29, size=(g, cap)).astype(np.int32)
        nbits[0, :3] = [28, 3, 28]
        nbits[0, 1016:1023] = 20
        x = (31 - int(nbits[0, :1016].sum()) - 140) % 32
        if x > 28:
            nbits[0, 1022] += 4
            x -= 4
        nbits[0, 1023], nbits[0, 1024] = x, 28
    else:
        g, cap, ow = 2, 4096, 4096
        nbits = rng.randint(0, 29, size=(g, cap)).astype(np.int32)
        nbits[:, 8:16] = 0
        nbits[0, 1000:2100] = 0
        nbits[1, 3:7] = 0
        nbits[:, -300:] = 0
    data = (rng.randint(0, 1 << 30, size=(g, cap)) & ((1 << nbits) - 1)).astype(np.uint32)
    pos = (np.cumsum(nbits, axis=1) - nbits).astype(np.int32)
    if case == "offset31_28bit":
        assert pos[0, 2] == 31 and pos[0, 1024] % 32 == 31 and nbits[0, 1024] == 28
    return data, nbits, pos, ow


def _i32_fields(*arrays):
    """numpy token fields -> int32 tensors (data as its uint32 pattern)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))
                 for a in arrays)


def _scalar_bitpack(data, nbits, ow):
    """Token-by-token reference packer for one group; words at or beyond
    ow are dropped."""
    out = np.zeros(max(ow, int(nbits.sum()) // 32 + 2), np.uint32)
    p = 0
    for d, nb in zip(data.tolist(), nbits.tolist()):
        out[p >> 5] |= (d << (p & 31)) & 0xFFFFFFFF
        if (p & 31) + nb > 32:
            out[(p >> 5) + 1] |= d >> (32 - (p & 31))
        p += nb
    return out[:ow]


# ---------------------------------------------------------------------------
# Plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", [1.0, 5.0])
def test_aq_field_matches_jax(jx, distance):
    """AQ kernel module: qf / masking within float tolerance, raw_qf exact
    (distance 5 turns the colour modulation off)."""
    xyb = _xyb_groups()
    distp = compute_distance_params(distance)
    jqf, jmask, jraw = (np.asarray(a) for a in jx.aq(
        jx.jnp.asarray(xyb), distp.distance, distp.inv_scale))
    qf, mask, raw = AQ.adaptive_quant_field(
        torch.from_numpy(xyb), distp.distance, distp.inv_scale)
    np.testing.assert_allclose(qf.numpy(), jqf, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mask.numpy(), jmask, rtol=1e-5, atol=1e-6)
    assert np.array_equal(raw.numpy(), jraw)


def test_quantize_cells_matches_jax(jx):
    """Quantize kernel module, all three strategies: every output exact."""
    args = _quant_inputs()
    distp = compute_distance_params(1.0)
    sc = (distp.scale, distp.scale_dc, distp.x_qm_mul)
    want = [np.asarray(a) for a in jx.quantize(*[jx.jnp.asarray(a) for a in args], *sc)]
    got = QK.quantize_cells(*[torch.from_numpy(a) for a in args], TABLES, *sc)
    for name, w, g_ in zip(("ordered", "nzeros", "qdc", "lastnz"), want, got):
        assert np.array_equal(g_.numpy(), w), name
    nz = (want[0] != 0).mean()
    assert 0.05 < nz < 0.6, nz  # the inputs exercise both branches


def test_tokenize_cells_matches_jax(jx):
    """Tokenize kernel module: tokens exact."""
    args = _token_rows()
    want, _ = jx.tokenize(*[jx.jnp.asarray(a) for a in args])
    got = TK.tokenize_cells(*[torch.from_numpy(a) for a in args], TABLES)
    assert np.array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("variant", ["classic", "hier"])
def test_compact_stream_matches_jax(jx, variant):
    """Row compaction against both Pallas compaction kernels: streams exact
    for groups within the cap (positions below cap-128 for the over-cap
    group, whose tail both JAX kernels leave unspecified); totals exact."""
    tok, cnt = _rows(5, 2, over_cap=True)
    cap = 32768
    fn = jx.PK.compact_stream if variant == "classic" else jx.PK.compact_stream_hier
    js, jt = fn(jx.jnp.asarray(tok.view(np.uint32)), jx.jnp.asarray(cnt), cap)
    js, jt = np.asarray(js), np.asarray(jt)
    s, t = PK.compact_stream(torch.from_numpy(tok), torch.from_numpy(cnt), cap)
    s = u32(s)
    assert np.array_equal(t.numpy(), jt)
    assert jt[-1] > cap and (jt[:-1] <= cap).all()
    assert np.array_equal(s[:-1], js[:-1])
    assert np.array_equal(s[-1, : cap - 128], js[-1, : cap - 128])


def test_compact_sections_matches_jax(jx):
    rng = np.random.RandomState(6)
    g, ow = 5, 1024
    bits = rng.randint(0, 32 * (ow - 40), size=g).astype(np.int32)
    bits[2] = 0
    packed = rng.randint(0, 1 << 32, size=(g, ow), dtype=np.uint64).astype(np.uint32)
    packed[np.arange(ow)[None, :] >= ((bits + 31) // 32)[:, None]] = 0
    wcap = 8192
    jb, jo = jx.PK.compact_sections(jx.jnp.asarray(packed), jx.jnp.asarray(bits), wcap)
    b, o = PK.compact_sections(torch.from_numpy(packed.view(np.int32)),
                               torch.from_numpy(bits), wcap)
    assert np.array_equal(u32(b), np.asarray(jb))
    assert np.array_equal(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("case", ROW_CASES)
@pytest.mark.parametrize("variant", ["classic", "hier"])
def test_compact_stream_cases_match_jax(jx, variant, case):
    """Row compaction on the inputs an output-driven placement is sensitive
    to, against both Pallas compaction kernels: streams and totals exact
    (the over-cap group below cap-128, as above)."""
    tok, cnt, cap = _rows_case(case)
    fn = jx.PK.compact_stream if variant == "classic" else jx.PK.compact_stream_hier
    js, jt = fn(jx.jnp.asarray(tok.view(np.uint32)), jx.jnp.asarray(cnt), cap)
    js, jt = np.asarray(js), np.asarray(jt)
    s, t = PK.compact_stream(torch.from_numpy(tok), torch.from_numpy(cnt), cap)
    s = u32(s)
    assert np.array_equal(t.numpy(), jt)
    assert (jt > cap).any() == (case == "over_cap")
    for k in range(len(jt)):
        keep = cap + 128 if jt[k] <= cap else cap - 128
        assert np.array_equal(s[k, :keep], js[k, :keep]), k
        assert not s[k, min(int(jt[k]), cap):].any()


@pytest.mark.parametrize("case", SECTION_CASES)
def test_compact_sections_cases_match_jax(jx, case):
    """Section copy with empty sections at either end and in the middle, a
    section that fills its [ow] row, and a single group: buffer and offsets
    exact."""
    packed, bits, wcap = _sections_case(case)
    jb, jo = jx.PK.compact_sections(jx.jnp.asarray(packed), jx.jnp.asarray(bits), wcap)
    b, o = PK.compact_sections(torch.from_numpy(packed.view(np.int32)),
                               torch.from_numpy(bits), wcap)
    assert np.array_equal(u32(b), np.asarray(jb))
    assert np.array_equal(o.numpy(), np.asarray(jo))
    nblk = (bits.astype(np.int64) + 4095) // 4096
    assert not u32(b)[int(nblk.sum()) * 128:].any()


def test_copy_sections_plain_takes_unaligned_sizes():
    """The plain version (what a CPU tensor gets) has no 128-word rule for
    ow and wcap; sections past wcap are cut."""
    rng = np.random.RandomState(41)
    packed = torch.from_numpy(rng.randint(1, 1 << 20, size=(3, 200)).astype(np.int32))
    nblk = torch.tensor([1, 2, 1])
    offs = torch.tensor([0, 128, 384])
    buf = PK.copy_sections(packed, nblk, offs, 500)
    want = np.zeros(500, np.int32)
    want[0:128] = packed[0, :128].numpy()
    want[128:328] = packed[1, :200].numpy()  # the row ends before its second block does
    want[384:500] = packed[2, :116].numpy()
    assert np.array_equal(buf.numpy(), want)


def _stream_and_table(seed=7, g=3, cap=2048):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 64, size=(g, cap))
    value = np.minimum(rng.geometric(0.05, size=(g, cap)) - 1, 65535)
    stream = ((base << 16) | value).astype(np.int32)
    totals = np.array([cap, cap // 3, 0][:g], np.int32)
    hist = rng.randint(0, 50, size=(64, 64)).astype(np.uint32)
    hist[:, 20:] = 0
    _, d_table = build_ac_device_code(hist, PK.ac_base64_map())
    return stream, totals, d_table


def test_hist_base64_matches_jax(jx):
    stream, totals, _ = _stream_and_table()
    want = np.asarray(jx.PK.hist_base64(jx.jnp.asarray(stream.view(np.uint32)),
                                        jx.jnp.asarray(totals)))
    got = PK.hist_base64(torch.from_numpy(stream), torch.from_numpy(totals))
    assert np.array_equal(got[0].numpy(), want.astype(np.int64))


def test_token_data_bits_matches_jax(jx):
    stream, totals, d_table = _stream_and_table()
    jd, jn = jx.PK.token_data_bits(jx.jnp.asarray(stream.view(np.uint32)),
                                   jx.jnp.asarray(totals), jx.jnp.asarray(d_table))
    d, n = PK.token_data_bits(torch.from_numpy(stream), torch.from_numpy(totals),
                              torch.from_numpy(d_table))
    assert np.array_equal(d.numpy(), np.asarray(jd).astype(np.int64))
    assert np.array_equal(n.numpy(), np.asarray(jn).astype(np.int64))


def _ac_bits(seed=8):
    stream, totals, d_table = _stream_and_table(seed)
    d, n = PK.token_data_bits(torch.from_numpy(stream), torch.from_numpy(totals),
                              torch.from_numpy(d_table))
    ends = torch.cumsum(n, 1)
    return d, n, ends - n


def _interleaved_bits(seed=9, g=2, cap=2048):
    """Tokens with zero-width entries anywhere, in runs (the DC layout's
    structural padding): the prefix_valid=False case."""
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 29, size=(g, cap)).astype(np.int64)
    runs = np.repeat(rng.rand(g, cap // 64) < 0.3, 64, axis=1)
    n[runs | (rng.rand(g, cap) < 0.2)] = 0
    n[:, -100:] = 0  # trailing padding
    d = (rng.randint(0, 1 << 28, size=(g, cap)) & ((1 << n) - 1)).astype(np.int64)
    d, n = torch.from_numpy(d), torch.from_numpy(n)
    ends = torch.cumsum(n, 1)
    return d, n, ends - n


@pytest.mark.parametrize("prefix_valid", [True, False])
def test_bitpack_groups_words_matches_jax(jx, prefix_valid):
    """Word packing in both modes: AC streams (tokens end in an empty tail)
    and the DC layout (zero-width entries interleave). Words exact.

    The AC stream's code lacks a few of its token values, so groups 0 and 1
    each hold one empty token before their last token with bits. The port
    packs every bit there (equal to the scatter-add reference); the JAX
    package scans the empty token in place and loses bits from its word on
    (tests/test_torch_empty_tokens.py), so the two are equal up to that
    word."""
    d, n, pos = _ac_bits() if prefix_valid else _interleaved_bits()
    ow = 8192
    assert int((n.sum(1).max() + 31) // 32) <= PK.var_safe_words(ow)
    want = np.asarray(jx.PK.bitpack_groups_words(
        jx.jnp.asarray(d.numpy().astype(np.uint32)),
        jx.jnp.asarray(n.numpy().astype(np.int32)),
        jx.jnp.asarray(pos.numpy().astype(np.int32)), ow, prefix_valid=prefix_valid))
    got = u32(PK.bitpack_groups_words(d, n, pos, ow, prefix_valid=prefix_valid))
    if not prefix_valid:
        assert np.array_equal(got, want)
        return
    assert np.array_equal(got, u32(PK.bitpack_groups_var_plain(d, n, pos, ow)))
    inside = []
    for g in range(len(got)):
        bits = (n[g] > 0).numpy()
        last = np.flatnonzero(bits).max() if bits.any() else -1
        empty = np.flatnonzero(~bits[:last + 1])
        w = int(pos[g, empty[0]]) // 32 if len(empty) else ow
        inside.append(len(empty))
        assert np.array_equal(got[g, :w], want[g, :w]), g
    assert inside == [1, 1, 0]


def test_dc_layout_and_hist_match_jax(jx):
    maps, geo = _dc_maps()
    want = jx.DK.build_dc_layout(*[jx.jnp.asarray(a) for a in maps],
                                 *[jx.jnp.asarray(a) for a in geo])
    got = DK.build_dc_layout(*[torch.from_numpy(a) for a in maps],
                             *[torch.from_numpy(a) for a in geo], TABLES)
    assert np.array_equal(u32(got), np.asarray(want))
    assert np.array_equal(DK.dc_hist(got)[0].numpy(),
                          np.asarray(jx.DK.dc_hist(want)).astype(np.int64))


@pytest.mark.parametrize("family", ["16x8", "8x16"])
def test_dct16_from_8_matches_jax(jx, family):
    """The 16x8 / 8x16 transforms recombined from pairs of 8x8 DCTs."""
    rng = np.random.RandomState(11)
    a = (rng.randn(2, 3, 16, 32, 8, 8) * 0.05).astype(np.float32)
    b = (rng.randn(2, 3, 16, 32, 8, 8) * 0.05).astype(np.float32)
    jfn, fn = {"16x8": (jx.DCT.dct16x8_from_8, DCT.dct16x8_from_8),
               "8x16": (jx.DCT.dct8x16_from_8, DCT.dct8x16_from_8)}[family]
    want = np.asarray(jfn(jx.jnp.asarray(a), jx.jnp.asarray(b)))
    got = fn(torch.from_numpy(a), torch.from_numpy(b), TABLES.dct16_a0, TABLES.dct16_a1)
    assert got.shape == want.shape == (2, 3, 16, 32, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ceil_log2_nz_exact(jx):
    """The exponent-bitcast ceil(log2) on 1..2^24: every power of two with
    its neighbours, and random samples; exact against integer arithmetic
    and against the JAX package's."""
    rng = np.random.RandomState(13)
    pows = 1 << np.arange(25)
    v = np.unique(np.concatenate([
        [0], pows, pows - 1, pows[:-1] + 1, np.arange(1, 4097),
        rng.randint(1, (1 << 24) + 1, size=200000),
    ]))
    v = v[v <= 1 << 24].astype(np.int32)
    want = np.array([max(int(x), 1) - 1 for x in v], np.int64)
    want = np.array([int(x).bit_length() for x in want], np.int32)
    got = SK._ceil_log2_nz(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jx.SK._ceil_log2_nz(jx.jnp.asarray(v))).astype(np.int32))


def test_estimate_partials_matches_jax(jx):
    """Strategy kernel module: the per-channel partials of all three
    families against the Pallas kernel (interpret mode)."""
    args = _estimate_inputs()
    slope = min(1.0, 1.0 / 3.0)
    want = jx.SK.estimate_partials(*[jx.jnp.asarray(a) for a in args], slope)
    got = SK.estimate_partials(*[torch.from_numpy(a) for a in args], slope)
    for name, w, g_ in zip(("p8", "pv", "ph"), want, got):
        w = np.asarray(w)
        assert g_.shape == w.shape, name
        np.testing.assert_allclose(g_.numpy(), w, rtol=5e-5, err_msg=name)


def _estimate_entropy_plain(coef, qm, q, masking, fac_x, fac_b, distance):
    """Whole-cell estimate in plain torch, written after the JAX package's
    `_estimate_entropy`: a second model that the port's partials +
    combine_partials are held against (library reductions, so equal only
    up to summation order).

    coef: [G,3,...,S]; qm: [3,S]; q/masking/fac_*: [G,...] -> [G,...]."""
    num_blocks = coef.shape[-1] // 64
    cf = torch.stack([fac_x, torch.zeros_like(fac_x), fac_b], dim=1)
    qm_b = qm.reshape((1, 3) + (1,) * (coef.dim() - 3) + (-1,))
    val = (coef - cf[..., None] * coef[:, 1:2]) * qm_b * q[:, None, ..., None]
    rval = torch.round(val)
    diff = torch.abs(val - rval)
    info_loss = diff.sum(dim=(1, -1))
    info_loss2 = (diff * diff).sum(dim=(1, -1))
    aq = torch.abs(rval)
    nzeros = (aq != 0).sum(dim=-1)
    slope = min(1.0, distance / 3.0)
    ent = (
        (aq >= 1.5).sum(dim=-1) * float(SK.K_ABOVE15)
        + torch.sqrt(aq).sum(dim=-1) * float(SK.K_SQRT)
        + nzeros * float(SK.nz_cost(slope))
    )
    nbits = SK._ceil_log2_nz(nzeros + 1) + 1
    ent = ent + float(SK.K_NBITS) * (SK._ceil_log2_nz(nbits + 17) + nbits)
    score = float(SK.K_IL) * info_loss + float(SK.K_IL2) * torch.sqrt(num_blocks * info_loss2)
    return ent.sum(dim=1) + masking * score


@pytest.mark.parametrize("realistic", [True, False], ids=["scaled", "unit_normal"])
@pytest.mark.parametrize("family", ["8x8", "16x8", "8x16"])
def test_combined_estimates_match_jax(jx, family, realistic):
    """Partials + combine_partials against the JAX package's kernel +
    combine, against its whole-cell twin _estimate_entropy, and against the
    plain torch copy of that twin above."""
    args = _estimate_inputs(seed=4, realistic=realistic)
    k = {"8x8": 0, "16x8": 1, "8x16": 2}[family]
    distance = 2.0
    slope = min(1.0, distance / 3.0)
    nb = 1 if k == 0 else 2
    coef, q, m, fac = args[k], args[3 + k], args[6 + k], args[9 + k]
    qm = args[12] if k == 0 else args[13]
    j = jx.jnp.asarray
    jp = jx.SK.estimate_partials(*[j(a) for a in args], slope)[k]
    want_kernel = np.asarray(jx.SK.combine_partials(jp, j(m), nb))
    want_twin = np.asarray(jx.PJ._estimate_entropy(
        j(coef), j(qm), j(q), j(m), j(fac[:, 0]), j(fac[:, 1]), distance))
    t = torch.from_numpy
    p = SK.estimate_partials(*[t(a) for a in args], slope)[k]
    got = SK.combine_partials(p, t(m), nb).numpy()
    own_twin = _estimate_entropy_plain(
        t(coef), t(qm), t(q), t(m), t(fac[:, 0]), t(fac[:, 1]), distance).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=5e-5)
    np.testing.assert_allclose(got, want_twin, rtol=5e-5)
    np.testing.assert_allclose(got, own_twin, rtol=5e-5)


def _jax_strategy_case(jx, yb, xb):
    """photo256 through the JAX package's stages up to the strategy search:
    its cost maps (computed as compute_ac_strategy computes them) and its
    decisions."""
    j = jx.jnp.asarray
    xyb = j(_xyb_groups()[:1])
    distance = 1.0
    distp = compute_distance_params(distance)
    qf, masking, raw_qf = jx.aq(xyb, distp.distance, distp.inv_scale)
    blocks8 = xyb.reshape(1, 3, 32, 8, 32, 8).transpose(0, 1, 2, 4, 3, 5)
    coef8 = jx.DCT.dct2d(blocks8, 8, 8)
    ybv, xbv = j(np.array([yb], np.int32)), j(np.array([xb], np.int32))
    ar = np.arange(32)
    valid = j((ar[None, :, None] < yb) & (ar[None, None, :] < xb))
    ytox, ytob = jx.PJ.compute_cmap(coef8, valid)
    strategy, is_first, coef_v, coef_h = jx.PJ.compute_ac_strategy(
        xyb, coef8, qf, masking, ytox, ytob, distance, ybv, xbv)
    icf = np.float32(1.0 / 84)
    fac_x = jx.jnp.repeat(jx.jnp.repeat(ytox.astype(np.float32), 8, 1), 8, 2) * icf
    fac_b = 1.0 + jx.jnp.repeat(jx.jnp.repeat(ytob.astype(np.float32), 8, 1), 8, 2) * icf
    mx = jx.jnp.maximum
    q_v, m_v = mx(qf[:, ::2], qf[:, 1::2]), mx(masking[:, ::2], masking[:, 1::2])
    q_h, m_h = mx(qf[:, :, ::2], qf[:, :, 1::2]), mx(masking[:, :, ::2], masking[:, :, 1::2])
    fac = jx.jnp.stack([fac_x, fac_b], axis=1)
    p8, pv, ph = jx.SK.estimate_partials(
        coef8.reshape(1, 3, 32, 32, 64), coef_v, coef_h, qf, q_v, q_h,
        masking, m_v, m_h, fac, fac[:, :, ::2], fac[:, :, :, ::2],
        NP_TABLES["qm8"], NP_TABLES["qm16"], min(1.0, distance / 3.0))
    f = np.float32
    mul8 = f(1.0735757687292623 * 0.75 + (-0.55 * 0.75) / (distance + 1.4))
    mul16 = f(0.9019587899705066 + (-0.55) / (distance + 1.6))
    e8 = f(3.0) * mul8 + mul8 * jx.SK.combine_partials(p8, masking, 1)
    ev = mul16 * jx.SK.combine_partials(pv, m_v, 2)
    eh = mul16 * jx.SK.combine_partials(ph, m_h, 2)
    return dict(
        e=[np.array(a) for a in (e8, ev, eh)], yb=np.array(ybv), xb=np.array(xbv),
        strategy=np.array(strategy), is_first=np.array(is_first),
        raw_qf=np.array(raw_qf), coef8=np.array(coef8), qf=np.array(qf),
        masking=np.array(masking), ytox=np.array(ytox), ytob=np.array(ytob),
        adjusted=np.array(jx.PJ.adjust_quant_field(strategy, is_first, raw_qf)),
    )


@pytest.mark.parametrize("yb,xb", [(32, 32), (19, 27)], ids=["full", "partial"])
def test_strategy_decisions_match_jax(jx, yb, xb):
    """The quad decisions fed the JAX package's cost maps, and the quant
    field adjustment that follows: exact. The port's own cost maps on the
    same inputs agree within the estimate tolerance. `partial` is a group
    at the image edge (odd valid dims: quads that straddle the edge stay
    DCT8)."""
    c = _jax_strategy_case(jx, yb, xb)
    t = torch.from_numpy
    strategy, is_first = PL.decide_strategy(*[t(a) for a in c["e"]], t(c["yb"]), t(c["xb"]))
    assert np.array_equal(strategy.numpy(), c["strategy"])
    assert np.array_equal(is_first.numpy(), c["is_first"])
    shares = [(c["strategy"] == k).mean() for k in range(3)]
    assert min(shares[1:]) > 0.2, shares  # both two-cell transforms occur
    if (yb, xb) != (32, 32):
        assert (c["strategy"][0, yb - 1:, :] == 0).all()
        assert (c["strategy"][0, :, xb - 1:] == 0).all()
    adjusted = PL.adjust_quant_field(strategy, is_first, t(c["raw_qf"]))
    assert np.array_equal(adjusted.numpy(), c["adjusted"])
    assert (c["adjusted"] != c["raw_qf"]).any()
    own = PL.strategy_estimates(
        t(c["coef8"]), t(c["qf"]), t(c["masking"]), t(c["ytox"]), t(c["ytob"]),
        1.0, TABLES)
    for got, want in zip(own[:3], c["e"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-5)


@pytest.mark.parametrize("case", ["safe_fill", "zero_runs", "max_widths"])
def test_bitpack_groups_var_matches_jax(jx, case):
    """The token bit packer against the Pallas variable-window packer
    (interpret mode) and the scalar reference: words exact. It also equals
    bitpack_groups_words where that packer's precondition holds (no
    interleaved zero widths)."""
    data, nbits, pos, ow = _var_token_fields(case)
    if case == "safe_fill":
        assert int(nbits.sum()) > 32 * PK.var_safe_words(ow) - 28 * 8
    j = jx.jnp.asarray
    want = np.asarray(jx.PK.bitpack_groups_var(j(data), j(nbits), j(pos), ow))
    d, n, p = _i32_fields(data, nbits, pos)
    got = u32(PK.bitpack_groups_var(d, n, p, ow))
    assert np.array_equal(got[0], _scalar_bitpack(data[0], nbits[0], ow))
    assert np.array_equal(got, want)
    d64, n64, p64 = (torch.from_numpy(a.astype(np.int64)) for a in (data, nbits, pos))
    words = u32(PK.bitpack_groups_words(d64, n64, p64, ow, prefix_valid=case == "safe_fill"))
    assert np.array_equal(got, words)


def test_bitpack_groups_var_drops_words_beyond_ow():
    """Tokens at or beyond ow words leave the kept words untouched."""
    data, nbits, pos, ow = _var_token_fields("max_widths")
    d, n, p = _i32_fields(data, nbits, pos)
    full = u32(PK.bitpack_groups_var(d, n, p, ow))
    cut = u32(PK.bitpack_groups_var(d, n, p, 100))
    assert np.array_equal(cut, full[:, :100]) and full[:, 100:].any()


@pytest.mark.parametrize("space", ["ac", "dc"])
def test_select_code_table_matches_jax(jx, space):
    """The static tier's candidate pick: equal to the plain int64 argmin and
    to the JAX package's split-sum pick, on histograms that favour
    different candidates."""
    from jxl_tiny_tpu_torch.entropy.entropy_write import load_static_codes

    sc = load_static_codes()
    depths = sc.ac_depths if space == "ac" else sc.dc_depths
    rng = np.random.RandomState(14)
    picks = set()
    for trial in range(6):
        hist = (rng.gamma(0.3, 2000.0, size=(64, 64)) * (rng.rand(64, 1) < 0.6)).astype(np.uint32)
        if trial == 0:
            hist[3, 5] = np.uint32(3_000_000_000)  # one bin beyond int32
        if space == "dc":
            hist[45:] = 0
        want = int(np.argmin((hist.astype(np.int64)[None] * depths).sum(axis=(1, 2))))
        got = int(DK.select_code_table(torch.from_numpy(hist.astype(np.int64)),
                                       torch.from_numpy(depths)))
        assert got == want
        assert got == int(jx.DK.select_code_table(jx.jnp.asarray(hist), jx.jnp.asarray(depths)))
        picks.add(got)
    assert len(picks) > 1


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each kernel wrapper runs its plain version and counts
    no launch."""
    wrappers = (AQ.aq_field, QK.quantize_cells, TK.tokenize_rows,
                PK.compact_rows, PK.copy_sections, SK.estimate_partials,
                PK.bitpack_groups_var)
    before = [w.launches for w in wrappers]
    tok, cnt = _rows(9, 1)
    AQ.aq_field(torch.zeros((1, 3, 256, 256)), 1.0)
    PK.compact_stream(torch.from_numpy(tok), torch.from_numpy(cnt), 32768)
    PK.compact_sections(torch.zeros((2, 256), dtype=torch.int32),
                        torch.tensor([100, 5000]), 1024)
    SK.estimate_partials(*[torch.from_numpy(a) for a in _estimate_inputs(g=1)], 0.5)
    z = torch.zeros((1, 128), dtype=torch.int32)
    PK.bitpack_groups_var(z, z, z, 64)
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# The decompositions the CUDA kernels use, emulated on the CPU
# ---------------------------------------------------------------------------

# csrc/aq.cu:erode's sorting network.
_SORT9 = ((0, 3), (1, 7), (2, 5), (4, 8), (0, 7), (2, 4), (3, 8), (5, 6),
          (0, 2), (1, 3), (4, 5), (7, 8), (1, 4), (3, 6), (5, 7), (0, 1),
          (2, 4), (3, 5), (6, 8), (2, 3), (4, 5), (6, 7), (1, 2), (3, 4), (5, 6))


def _aq_field_strips(xyb, consts, color, strip_blocks):
    """csrc/aq.cu's decomposition in torch: each strip of `strip_blocks`
    block rows is finished on its own from the pixel rows it loads, with
    the one pre-erosion cell row above and below recomputed, every row and
    cell index clamped at the group's edge (never at the strip's), the
    erosion through the kernel's sorting network and the sums in the
    pinned order."""
    from jxl_tiny_tpu_torch.ref.pipeline_np import strided_sum

    k = AQ._k(consts)
    rod = AQ._ratio_of_derivatives
    x_pl, y_pl, b_pl = xyb[:, 0], xyb[:, 1], xyb[:, 2]
    cols = torch.arange(256)
    lf, rt = (cols - 1).clamp_min(0), (cols + 1).clamp_max(255)
    vals, gammas, masks = [], [], []
    for strip in range(32 // strip_blocks):
        cy0 = strip * 2 * strip_blocks
        c_lo, c_hi = max(cy0 - 1, 0), min(cy0 + 2 * strip_blocks, 63)
        rows = torch.arange(4 * c_lo, 4 * c_hi + 4)
        up, dn = (rows - 1).clamp_min(0), (rows + 1).clamp_max(255)
        yc, xc = y_pl[:, rows], x_pl[:, rows]
        gammac = rod(yc + k["gamma_off"], False, k)

        def diffsq(p, pc):
            base = 0.25 * (p[:, dn] + p[:, up] + pc[:, :, lf] + pc[:, :, rt])
            d = gammac * (pc - base)
            return d * d

        v = diffsq(y_pl, yc) + k["diff_x_w"] * diffsq(x_pl, xc)
        diff = 0.25 * torch.sqrt((v * k["msq_mul"] + k["msq_add"]).double()).float()
        pe = strided_sum(strided_sum(diff, 4, 2), 4, 1) * 0.25  # cell rows c_lo..c_hi

        own = torch.arange(cy0, cy0 + 2 * strip_blocks)
        ccol = torch.arange(64)
        n = [pe[:, ((own + dy).clamp(0, 63) - c_lo)][:, :, (ccol + dx).clamp(0, 63)]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        centre = n[4]
        for a, b in _SORT9:
            n[a], n[b] = torch.minimum(n[a], n[b]), torch.maximum(n[a], n[b])
        ve = 0.05 * (centre + ((n[0] + n[1]) + (n[2] + n[3])))
        aq = strided_sum(strided_sum(ve, 2, 2), 2, 1)
        masks.append(1.0 / (aq + k["masking_add"]))
        val = AQ._compute_mask(aq, k)

        prow = torch.arange(8 * strip_blocks * strip, 8 * strip_blocks * (strip + 1))
        yb, xb, bb = y_pl[:, prow], x_pl[:, prow], b_pl[:, prow]
        right = torch.abs(yb - yb[:, :, rt])
        right = torch.where((cols % 8 == 7)[None, None, :], torch.zeros_like(right), right)
        down = torch.abs(yb - y_pl[:, (prow + 1).clamp_max(255)])
        down = torch.where((prow % 8 == 7)[None, :, None], torch.zeros_like(down), down)
        val = val + AQ._block_sums(right + down) * k["hf_mul"]
        if color:
            red = torch.clamp_max(torch.clamp_min(xb - k["red_off"], 0.0), k["red_max"])
            blue = torch.clamp_max(
                torch.clamp_min(bb - (yb + k["blue_off"]), 0.0), k["blue_max"])
            red_cov = torch.clamp_max(AQ._block_sums(red), k["red_cap"])
            blue_cov = torch.clamp_max(AQ._block_sums(blue), k["blue_cap"])
            val = val + k["color_c1"] + red_cov * k["color_c2"] + blue_cov * k["color_c3"]
        yo = yb + k["gamma_y_off"]
        gammas.append(AQ._block_sums(
            0.5 * (rod(yo - xb, True, k) + rod(yo + xb, True, k))))
        vals.append(val)
    return torch.cat(vals, 1), torch.cat(gammas, 1), torch.cat(masks, 1)


@pytest.mark.parametrize("strip_blocks", [4, 2, 8])
@pytest.mark.parametrize("distance", [1.0, 5.0])
def test_aq_strip_decomposition_equals_plain(distance, strip_blocks):
    """The AQ kernel's strips (halo cell rows recomputed, clamped at the
    group's edge only, sorting network, pinned sum order) give aq_field_plain
    bit for bit, with (distance 1) and without (distance 5) the colour
    modulation, on groups whose rows and columns differ everywhere."""
    xyb = torch.from_numpy(_xyb_groups())
    assert (xyb[:, :, 1:] != xyb[:, :, :-1]).any(-1).all()
    assert (xyb[:, :, :, 1:] != xyb[:, :, :, :-1]).any(-2).all()
    consts, color = AQ.aq_constants(distance)
    assert color == (distance == 1.0)
    want = AQ.aq_field_plain(xyb, consts, color)
    got = _aq_field_strips(xyb, consts, color, strip_blocks)
    for name, a, b in zip(("val", "gamma", "masking"), got, want):
        assert a.shape == b.shape == (2, 32, 32)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.parametrize("strategy", [0, 1, 2], ids=["dct8", "dct16x8", "dct8x16"])
def test_zigzag_tables_equal_order_tab_applied(strategy):
    """The tables the quantize kernel reads (already in zig-zag order) are
    order_tab applied to the natural ones, entry by entry."""
    s = strategy
    qm_zz, thr_zz, dqm_zz, order_zz = (
        TABLES.qm_zz, TABLES.thr_zz, TABLES.dqm_zz, TABLES.order_zz)
    dc_pos = TABLES.dc_pos
    order = NP_TABLES["order_tab"][s]
    assert sorted(order) == list(range(128))
    for c in range(3):
        assert np.array_equal(qm_zz[s, c].numpy(), NP_TABLES["qm_tab"][s, c][order])
        assert np.array_equal(thr_zz[s, c].numpy(), NP_TABLES["thr_tab"][s, c][order])
    assert np.array_equal(dqm_zz[s].numpy(), NP_TABLES["dqm_tab"][s, 1][order])
    words = order_zz[s].numpy().view(np.uint32)
    unpacked = np.stack([(words >> (8 * e)) & 0xFF for e in range(4)], axis=1)
    assert np.array_equal(unpacked.reshape(-1), order)
    assert [order[p] for p in dc_pos[s]] == [0, 1]
    # What a lane of the kernel gathers equals the plain version's gather.
    q = torch.arange(3 * 128, dtype=torch.float32).reshape(3, 128)
    assert torch.equal(q[:, torch.from_numpy(unpacked.reshape(-1).astype(np.int64))],
                       torch.gather(q, 1, TABLES.order_tab.long()[s].expand(3, 128)))
    # The wrapper's scalar block is made once a quantization setting.
    params = QK.quantize_cells.params_for(0.5, 0.25, 1.0, dc_pos)
    assert QK.quantize_cells.params_for(0.5, 0.25, 1.0, dc_pos) is params
    assert list(params.dc_pos) == [p for pair in dc_pos for p in pair]


def _lane_reduction(x):
    """csrc/strategy.cu's sums, in numpy. x: [cells, 8, n] float32, eight
    sums a cell of n = 64 or 128 values each. L = n/4 lanes a cell (32/L
    cells a warp), lane l holding values l + L*i (i < 4) of every sum; the
    lane adds its elements i and i+2, then 0 and 1; then a butterfly over
    lanes L/2, L/4, L/8 apart, in which a lane keeps half of its sums and
    adds its partner's copy of that half, and two (or one) last levels on
    the one sum left. Returns [cells, 8]: each sum as the lane that ends
    with it holds it."""
    cells, _, n = x.shape
    lpc = n // 4
    per_warp = 32 // lpc
    v = x.reshape(cells, 8, 4, lpc)
    part = (v[:, :, 0] + v[:, :, 2]) + (v[:, :, 1] + v[:, :, 3])  # [cell, sum, lane]
    warps = cells // per_warp
    arr = part.reshape(warps, per_warp, 8, lpc).transpose(0, 1, 3, 2).reshape(warps, 32, 8)
    lane = np.arange(32)

    def fold(arr, m, off):
        upper = ((lane & off) != 0)[None, :, None]
        lo, hi = arr[:, :, : m // 2], arr[:, :, m // 2: m]
        send, keep = np.where(upper, lo, hi), np.where(upper, hi, lo)
        return keep + send[:, lane ^ off]

    arr = fold(fold(fold(arr, 8, lpc // 2), 4, lpc // 4), 2, lpc // 8)
    s = arr[:, :, 0]
    off = lpc // 16
    while off >= 1:
        s = s + s[:, lane ^ off]
        off //= 2
    src = (np.arange(per_warp)[:, None] * lpc + np.arange(8)[None, :] * (lpc // 8))
    return s[:, src].reshape(cells, 8)


@pytest.mark.parametrize("n", [64, 128])
def test_estimate_lane_reduction_equals_tree_sum(n):
    """The kernel's mapping of the halving tree onto lanes (two 8x8 cells
    or one 16x8 / 8x16 cell a warp, eight sums reduced together by a
    butterfly) is tree_sum bit for bit, on float32 values over six decades
    whose sums round at every level; the nonzero counts packed three to a
    float come out exact."""
    rng = np.random.RandomState(81)
    cells = 2048
    x = (rng.randn(cells, 8, n) * 10.0 ** rng.uniform(-3, 3, size=(cells, 8, n))).astype(np.float32)
    x[rng.rand(cells, 8, n) < 0.3] = 0.0
    x[:64] = 0.0
    nz = x[:, :3] != 0
    nz[64] = True  # a cell with every value nonzero
    x[:, 6] = (nz[:, 0] + 256 * nz[:, 1] + 65536 * nz[:, 2]).astype(np.float32)
    x[:, 7] = 0.0
    sums = _lane_reduction(x)
    want = SK.tree_sum(torch.from_numpy(x[:, :6])).numpy()
    assert np.array_equal(sums[:, :6].view(np.int32), want.view(np.int32))
    counts = sums[:, 6].astype(np.int64)
    for k in range(3):
        assert np.array_equal((counts >> (8 * k)) & 255, nz[:, k].sum(1))
    assert not np.array_equal(want, x[:, :6].sum(2, dtype=np.float32))  # the order matters


def _bitpack_runs(data, nbits, pos, ow, threads=128, run=8):
    """csrc/bitpack.cu's word merge in numpy: chunks of threads * run tokens,
    a run of consecutive tokens a thread merged with a 64-bit accumulator
    from the run's first position, words wholly inside a run stored, the
    run's first (shared) and last partial word ORed, the chunk's last word
    finished from the next 32 tokens and, for bits still missing, the token
    found by binary search to start at each, each chunk storing the words
    whose first bit it holds, the zero tail spread over the chunks. Checks
    that no stored word is touched by another thread, and that every output
    word is written exactly once."""
    m32 = 0xFFFFFFFF
    g, cap = data.shape
    chunk = threads * run
    chunks = -(-cap // chunk)
    out = np.zeros((g, ow), np.uint32)
    for gi in range(g):
        d, n, p = (a[gi].astype(np.int64).tolist() for a in (data, nbits, pos))
        writes = np.zeros(ow, np.int64)
        total = p[cap - 1] + n[cap - 1]
        wt = min((total + 31) >> 5, ow)
        zshare = -(-(ow - wt) // chunks)
        for c in range(chunks):
            t0 = c * chunk
            c0 = p[t0]
            c1 = p[t0 + chunk] if t0 + chunk < cap else total
            for k in range(wt + c * zshare, min(wt + (c + 1) * zshare, ow)):
                out[gi, k] = 0
                writes[k] += 1
            if c1 == c0:
                continue
            buf, stored, ored = [0] * (chunk + 2), {}, {}
            kb = c0 >> 5
            for th in range(threads):
                t = t0 + th * run
                p0 = p[t] if t < cap else total
                kfirst, left = (p0 >> 5) - kb, (p0 & 31) != 0
                acc, fill, k = 0, p0 & 31, (p0 >> 5) - kb
                for j in range(t, t + run):
                    nb = max(n[j], 0) if j < cap else 0
                    acc |= (d[j] if nb > 0 else 0) << fill
                    fill += nb
                    if fill >= 32:
                        if left and k == kfirst:
                            buf[k] |= acc & m32
                            ored.setdefault(k, set()).add(th)
                        else:
                            assert k not in stored and k not in ored
                            buf[k] = acc & m32
                            stored[k] = th
                        acc >>= 32
                        fill -= 32
                        k += 1
                if fill > 0 and acc & m32:
                    assert k not in stored
                    buf[k] |= acc & m32
                    ored.setdefault(k, set()).add(th)
            ws = c1 & ~31
            if c1 & 31 and ws >= c0 and c1 < total:
                we, w, reached = ws + 32, 0, total
                for j in range(t0 + chunk, t0 + chunk + 32):
                    reached = total
                    if j < cap:
                        reached = p[j] + max(n[j], 0)
                        if n[j] > 0 and p[j] < we:
                            w |= (d[j] << (p[j] - ws)) & m32
                for b in range(reached, min(we, total)):
                    lo = int(np.searchsorted(p, b, side="right")) - 1
                    assert lo >= t0 + chunk + 32
                    if p[lo] == b:
                        w |= (d[lo] << (b - ws)) & m32
                assert (c1 >> 5) - kb not in stored
                buf[(c1 >> 5) - kb] |= w
            for q in range((c0 + 31) >> 5, min((c1 + 31) >> 5, ow)):
                out[gi, q] = buf[q - kb]
                writes[q] += 1
        assert (writes == 1).all()
    return out


@pytest.mark.parametrize("threads", [128, 4], ids=["kernel_chunks", "chunks_of_32"])
@pytest.mark.parametrize("case", ["safe_fill", "zero_runs", "max_widths"] + BITPACK_EDGE_CASES)
def test_bitpack_run_merge_equals_scalar(case, threads):
    """The token packer's run merge (kernel chunks of 1,024 tokens, and
    chunks of 32 tokens, where every run and chunk edge is exercised) gives
    the token-by-token reference packer's words, and so does the plain
    version on int32 fields."""
    if case in BITPACK_EDGE_CASES:
        data, nbits, pos, ow = _bitpack_edge_fields(case)
    else:
        data, nbits, pos, ow = _var_token_fields(case)
    got = _bitpack_runs(data, nbits, pos, ow, threads=threads)
    plain = u32(PK.bitpack_groups_var(*_i32_fields(data, nbits, pos), ow))
    for k in range(data.shape[0]):
        want = _scalar_bitpack(data[k], nbits[k], ow)
        assert np.array_equal(got[k], want)
        assert np.array_equal(plain[k], want)


# ---------------------------------------------------------------------------
# Kernels against their plain versions on the card
# ---------------------------------------------------------------------------


def _same(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _xyb_seeded(g, seed=11):
    """[g,3,256,256] XYB of seeded smooth-plus-noise groups, each different."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    ph = rng.rand(g, 3, 1, 1).astype(np.float32) * 6.0
    base = 0.45 + 0.35 * np.sin(xx * 0.04 + ph) * np.cos(yy * 0.03 - ph)
    rgb = base + rng.randn(g, 3, 256, 256).astype(np.float32) * 0.03
    return PL.to_xyb(torch.from_numpy(np.clip(rgb, 0, 1).astype(np.float32)))


AQ_CARD_CASES = {"one_group": (1, 1.0), "three_groups": (3, 1.0),
                 "odd_135_groups": (135, 1.0), "no_colour": (2, 5.0),
                 "beyond_fast_range": (2, 1.0), "large_within_fast_range": (2, 1.0)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["photo_and_synthetic"] + list(AQ_CARD_CASES))
def test_aq_kernel_on_card(cuda, case):
    if case == "photo_and_synthetic":
        xyb, distance = torch.from_numpy(_xyb_groups()).to(cuda), 1.0
    else:
        g, distance = AQ_CARD_CASES[case]
        xyb = _xyb_seeded(g).to(cuda)
    if case == "beyond_fast_range":
        # Pixels so large that the kernel's in-range division and square
        # root do not apply: those rows take the compiler's own.
        xyb[:, :, 60:131, 30:97] *= 2.0e5
    if case == "large_within_fast_range":
        # Large operands that still take the in-range sequences (Y < 32768).
        xyb[:, :, 60:131, 30:97] *= 2.0e4
        assert float(xyb[:, 1].max()) + 0.16 + float(xyb[:, 0].abs().max()) < 32768.0
    consts, color = AQ.aq_constants(distance)
    assert color == (distance == 1.0)
    got = AQ.aq_field(xyb, distance)
    want = AQ.aq_field_plain(xyb, consts, color)
    assert all(_same(a, b) for a, b in zip(got, want))


def _quant_case(case):
    """Inputs of the quantize kernel at its edges: `mixed` has all three
    strategies inside every group, cell by cell (pairs that disagree are
    computed cell by cell); `all_pairs` is a map as the strategy search
    leaves it (every cell in a 16x8 or 8x16 pair with one quant field and
    one factor pair, which the kernel computes once and stores twice);
    `clamps` drives values beyond the AC and DC clamps."""
    args = _quant_inputs(g=1 if case == "one_group" else 2)
    if case == "all_dct8":
        args[3][:] = 0
    elif case == "all_pairs":
        by, bx = np.mgrid[0:32, 0:32]
        vert = ((by >> 1) + (bx >> 1)) % 2 == 0
        args[3][:] = np.where(vert, 1, 2)
        for a in args[4:7]:
            first = np.where(vert, a[:, by & ~1, bx], a[:, by, bx & ~1])
            a[:] = first
    elif case == "clamps":
        for a in args[:3]:
            a *= 4000.0
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "all_dct8", "all_pairs", "clamps", "one_group"])
def test_quantize_kernel_on_card(cuda, case):
    args = [torch.from_numpy(a).to(cuda) for a in _quant_case(case)]
    tabs = tables_from_numpy(NP_TABLES, cuda)
    distp = compute_distance_params(1.0)
    sc = (distp.scale, distp.scale_dc, distp.x_qm_mul)
    got = QK.quantize_cells(*args, tabs, *sc)
    want = QK.quantize_cells_plain(*args, tabs, *sc)
    assert all(_same(a, b) for a, b in zip(got, want))
    if case == "clamps":
        assert int(want[0].abs().max()) == 32767 and int(want[2].abs().max()) == 16383
    if case == "all_pairs":  # both cells of a pair hold the same values
        o = want[0]
        assert torch.equal(o[:, 0::4, 0], o[:, 1::4, 0]) and bool((o != 0).any())


@pytest.mark.gpu
def test_tokenize_kernel_on_card(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in _token_rows()]
    tabs = tables_from_numpy(NP_TABLES, cuda)
    got = TK.tokenize_cells(*args, tabs)
    want = TK.tokenize_cells(*args, tabs, kernels=False)
    assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed_over_cap", "many_rows"] + ROW_CASES)
def test_compact_rows_kernel_on_card(cuda, case):
    if case == "mixed_over_cap":
        tok, cnt = _rows(5, 2, over_cap=True)
        cap = 32768
    elif case == "many_rows":  # more rows than one staged chunk, sparse
        tok, cnt = _rows(6, 2, rows=6144)
        cnt[1, 100:6000] = 0
        cap = 32768
    else:
        tok, cnt, cap = _rows_case(case)
    tok, cnt = torch.from_numpy(tok).to(cuda), torch.from_numpy(cnt).to(cuda)
    before = PK.compact_rows.launches
    got = PK.compact_stream(tok, cnt, cap)
    torch.cuda.synchronize()
    assert PK.compact_rows.launches == before + 1
    want = PK.compact_stream(tok, cnt, cap, kernels=False)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ac_bits", "overflowing_rows", "many_groups"]
                         + SECTION_CASES)
def test_copy_sections_kernel_on_card(cuda, case):
    if case == "ac_bits":
        d, n, pos = (t.to(cuda) for t in _ac_bits())
        packed, bits, wcap = PK.bitpack_groups_words(d, n, pos, 8192), n.sum(1), 65536
    else:
        if case == "overflowing_rows":  # sections longer than their rows, and than wcap
            packed, bits, wcap = _sections_case("fills_ow")
            bits = bits + 32 * 1024
            wcap = 4096
        elif case == "many_groups":  # more groups than the kernel keeps in shared memory
            rng = np.random.RandomState(51)
            packed = rng.randint(0, 1 << 32, size=(700, 256), dtype=np.uint64).astype(np.uint32)
            bits = rng.randint(0, 32 * 256 + 1, size=700).astype(np.int32)
            wcap = 65536
        else:
            packed, bits, wcap = _sections_case(case)
        packed = torch.from_numpy(packed.view(np.int32)).to(cuda)
        bits = torch.from_numpy(bits).to(cuda)
    before = PK.copy_sections.launches
    got = PK.compact_sections(packed, bits, wcap)
    torch.cuda.synchronize()
    assert PK.copy_sections.launches == before + 1
    want = PK.compact_sections(packed, bits, wcap, kernels=False)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("ow,wcap", [(200, 1024), (256, 1000)])
def test_copy_sections_raises_on_unaligned_sizes(cuda, ow, wcap):
    """The kernel moves whole 128-word blocks: the wrapper refuses other
    sizes for a CUDA tensor and does not give way to the plain version."""
    packed = torch.zeros((2, ow), dtype=torch.int32, device=cuda)
    nblk = torch.tensor([1, 1], device=cuda)
    offs = torch.tensor([0, 128], device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        PK.copy_sections(packed, nblk, offs, wcap)


ESTIMATE_CARD_CASES = {"two_groups": 2, "one_group": 1, "three_groups": 3,
                       "unit_normal": 2, "scaled_1e30": 2, "infinite_coefficient": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ESTIMATE_CARD_CASES))
def test_estimate_kernel_on_card(cuda, case):
    """Exact at slope 1/3 and 1; `scaled_1e30` feeds the fast square root
    values far above an encoder's (still in its range, which holds every
    finite value); `infinite_coefficient` sends two warp items to the sqrtf
    fallback through NaN (a NaN equals any NaN: payloads may differ)."""
    g = ESTIMATE_CARD_CASES[case]
    args = [torch.from_numpy(a).to(cuda) for a in _estimate_inputs(
        g=g, realistic=case != "unit_normal")]
    if case == "scaled_1e30":
        args[:3] = [a * 1.0e30 for a in args[:3]]
    if case == "infinite_coefficient":
        args[0][0, 1, 5, 7, 9] = float("inf")
        args[2][1, 0, 30, 3, 100] = float("inf")
    for slope in (1.0 / 3.0, 1.0):
        got = SK.estimate_partials(*args, slope)
        want = SK.estimate_partials_plain(*args, slope)
        nans = [torch.isnan(a) & torch.isnan(b) for a, b in zip(got, want)]
        assert [bool(n.any()) for n in nans] == [case == "infinite_coefficient", False,
                                                 case == "infinite_coefficient"]
        assert all(_same(torch.where(n, 0.0, a), torch.where(n, 0.0, b))
                   for n, a, b in zip(nans, got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["safe_fill", "zero_runs", "max_widths"]
                         + BITPACK_EDGE_CASES + ["many_groups"])
def test_bitpack_var_kernel_on_card(cuda, case):
    if case == "many_groups":  # 300 groups of different lengths, zero widths inside
        rng = np.random.RandomState(61)
        nbits = rng.randint(0, 29, size=(300, 3000)).astype(np.int32)
        nbits[np.arange(3000)[None, :] >= rng.randint(0, 3001, size=(300, 1))] = 0
        nbits[rng.rand(300, 3000) < 0.3] = 0
        data = (rng.randint(0, 1 << 30, size=nbits.shape) & ((1 << nbits) - 1)).astype(np.uint32)
        pos = (np.cumsum(nbits, axis=1) - nbits).astype(np.int32)
        ow = 2700
    elif case in BITPACK_EDGE_CASES:
        data, nbits, pos, ow = _bitpack_edge_fields(case)
    else:
        data, nbits, pos, ow = _var_token_fields(case)
    d, n, p = (t.to(cuda) for t in _i32_fields(data, nbits, pos))
    got = PK.bitpack_groups_var(d, n, p, ow)
    assert _same(got, PK.bitpack_groups_var_plain(d, n, p, ow))
    for k in range(got.shape[0]):
        assert np.array_equal(u32(got.cpu())[k], _scalar_bitpack(data[k], nbits[k], ow))
    cut = PK.bitpack_groups_var(d, n, p, 100)
    assert _same(cut, got[:, :100].contiguous())


@pytest.mark.gpu
def test_bitpack_var_kernel_raises_on_int64_fields(cuda):
    """The kernel takes the JAX function's int32 fields; the wrapper refuses
    int64 for a CUDA tensor and does not give way to the plain version."""
    z = torch.zeros((2, 256), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        PK.bitpack_groups_var(z, z, z, 64)
