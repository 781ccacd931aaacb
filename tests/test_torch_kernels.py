"""Kernel modules of the PyTorch port against the JAX package.

Each plain torch version (what a kernel wrapper runs on a CPU tensor) gets
the same numpy-made inputs as its JAX twin; the Pallas kernels run in
interpret mode on the CPU, as in the JAX package's own tests. Tolerances:
integer outputs exact; float outputs (AQ qf / masking) rtol 1e-5, atol 1e-6,
since torch's and XLA's transcendental functions (exp2, log2) round
differently; raw_qf decisions exact.

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
from jxl_tiny_tpu_torch.ops import tokenize_kernel as TK
from jxl_tiny_tpu_torch.tables import numpy_tables, tables_from_numpy

TABLES = tables_from_numpy(numpy_tables(), "cpu")
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
    from jxl_tiny_tpu.ops import dc_kernels, pack_kernels
    from jxl_tiny_tpu.ops.aq_kernel import adaptive_quant_field_kernel
    from jxl_tiny_tpu.ops.quantize_kernel import quantize_cells
    from jxl_tiny_tpu.ops.tokenize_kernel import tokenize_cells

    return SimpleNamespace(
        jnp=jnp, DK=dc_kernels, PK=pack_kernels,
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
    assert np.array_equal(got.numpy(), want.astype(np.int64))


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
    """Word packing in both modes: AC streams (valid tokens form a prefix)
    and the DC layout (zero-width entries interleave). Words exact."""
    d, n, pos = _ac_bits() if prefix_valid else _interleaved_bits()
    ow = 8192
    assert int((n.sum(1).max() + 31) // 32) <= PK.var_safe_words(ow)
    want = jx.PK.bitpack_groups_words(
        jx.jnp.asarray(d.numpy().astype(np.uint32)),
        jx.jnp.asarray(n.numpy().astype(np.int32)),
        jx.jnp.asarray(pos.numpy().astype(np.int32)), ow, prefix_valid=prefix_valid)
    got = PK.bitpack_groups_words(d, n, pos, ow, prefix_valid=prefix_valid)
    assert np.array_equal(u32(got), np.asarray(want))


def test_dc_layout_and_hist_match_jax(jx):
    maps, geo = _dc_maps()
    want = jx.DK.build_dc_layout(*[jx.jnp.asarray(a) for a in maps],
                                 *[jx.jnp.asarray(a) for a in geo])
    got = DK.build_dc_layout(*[torch.from_numpy(a) for a in maps],
                             *[torch.from_numpy(a) for a in geo], TABLES)
    assert np.array_equal(u32(got), np.asarray(want))
    assert np.array_equal(DK.dc_hist(got).numpy(),
                          np.asarray(jx.DK.dc_hist(want)).astype(np.int64))


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each kernel wrapper runs its plain version and counts
    no launch."""
    wrappers = (AQ.aq_field, QK.quantize_cells, TK.tokenize_rows,
                PK.compact_rows, PK.copy_sections)
    before = [w.launches for w in wrappers]
    tok, cnt = _rows(9, 1)
    AQ.aq_field(torch.zeros((1, 3, 256, 256)), 1.0)
    PK.compact_stream(torch.from_numpy(tok), torch.from_numpy(cnt), 32768)
    PK.compact_sections(torch.zeros((2, 256), dtype=torch.int32),
                        torch.tensor([100, 5000]), 1024)
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# Kernels against their plain versions on the card
# ---------------------------------------------------------------------------


def _same(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.gpu
def test_aq_kernel_on_card(cuda):
    xyb = torch.from_numpy(_xyb_groups()).to(cuda)
    consts, color = AQ.aq_constants(1.0)
    got = AQ.aq_field(xyb, 1.0)
    want = AQ.aq_field_plain(xyb, consts, color)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_quantize_kernel_on_card(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in _quant_inputs()]
    tabs = TABLES.to(cuda)
    distp = compute_distance_params(1.0)
    sc = (distp.scale, distp.scale_dc, distp.x_qm_mul)
    got = QK.quantize_cells(*args, tabs, *sc)
    want = QK.quantize_cells_plain(*args, tabs, *sc)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_tokenize_kernel_on_card(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in _token_rows()]
    tabs = TABLES.to(cuda)
    got = TK.tokenize_cells(*args, tabs)
    want = TK.tokenize_cells(*args, tabs, kernels=False)
    assert _same(got, want)


@pytest.mark.gpu
def test_compact_rows_kernel_on_card(cuda):
    tok, cnt = _rows(5, 2, over_cap=True)
    tok, cnt = torch.from_numpy(tok).to(cuda), torch.from_numpy(cnt).to(cuda)
    got = PK.compact_stream(tok, cnt, 32768)
    want = PK.compact_stream(tok, cnt, 32768, kernels=False)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.gpu
def test_copy_sections_kernel_on_card(cuda):
    d, n, pos = (t.to(cuda) for t in _ac_bits())
    packed = PK.bitpack_groups_words(d, n, pos, 8192)
    bits = n.sum(1)
    got = PK.compact_sections(packed, bits, 65536)
    want = PK.compact_sections(packed, bits, 65536, kernels=False)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
