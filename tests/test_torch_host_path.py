"""The port's host-packed path (ops/pipeline_full.py, encoder.
encode_image_host_packed, the CLI's --pipeline host / numpy) against the
JAX package's (pipeline_jax.encode_groups, split_token_cells,
compact_token_stream, token_histogram, analyze_groups_jax,
analyze_image_fast, encoder.encode_image_jax), on the CPU. Integers and
bytes: exact.

(a) the full-context stages on gradient512's four groups, fed the same
    inputs (the JAX package's own decisions: coefficients, strategy and
    quant maps): encode_groups with full and base-64 contexts,
    split_token_cells, compact_token_stream (also at a cap below the
    largest group's total) and token_histogram
(b) analyze_groups on gradient512's groups and analyze_image_fast on
    odd131x77 (an edge group) in every ingest form: float32, float16,
    byte-plane float16 and u8 sRGB; every output
(c) make_analyze_fn (one group at a time through analyze_groups) against
    the port's numpy golden model, attribute by attribute
(d) encode_image_host_packed bytes against encode_image_jax on gradient512
    and odd131x77, fast and full, and with a cap small enough to force the
    analysis to run again; the JAX fast route is reached with a one-device
    mesh (its 8-device mesh shards the groups: same bytes)
(e) the CLI: --pipeline host and numpy with --device cpu, and the guard
    that keeps the tier flags to --pipeline device
(f) the device-packed and host-packed streams of the 176x272 synthetic of
    tests/test_device_pack.py decode to the same pixels
(g) the saturating quantizer (tests/test_hdr_input.py's extreme input,
    128x128 at d=0.1): the clamps engage in analyze_group_numpy, the device
    and host streams decode to the same pixels, the numpy stream stays
    within that test's relative bar"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tiny_tpu.encoder import _split_f16_planes
from jxl_tiny_tpu.encoder import encode_image_jax
from jxl_tiny_tpu.io.pfm import read_pfm
from jxl_tiny_tpu.ops import pipeline_jax as PJ
from jxl_tiny_tpu.ops.dct_jax import dct2d
from jxl_tiny_tpu.parallel import make_mesh as j_make_mesh

import jxl_tiny_tpu_torch.constants as C
import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch import cli
from jxl_tiny_tpu_torch.common import compute_distance_params
from jxl_tiny_tpu_torch.decode import decode_jxl
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
from jxl_tiny_tpu_torch.ops import pipeline_full as PF
from jxl_tiny_tpu_torch.tables import device_tables

TABLES = device_tables("cpu")
DISTP = compute_distance_params(1.0)
SCALARS = (DISTP.scale, DISTP.scale_dc, DISTP.x_qm_mul)
JKW = dict(distance=1.0, inv_scale=DISTP.inv_scale, scale=DISTP.scale,
           scale_dc=DISTP.scale_dc, x_qm_mul=DISTP.x_qm_mul)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.uint32 and got.dtype == np.int32:  # u32 words held as int32
        got = got.view(np.uint32)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), (
        f"{what}: {(got.astype(np.int64) != want.astype(np.int64)).sum()} elements differ")


def _image(testdata, name):
    return read_pfm(os.path.join(testdata, f"{name}.pfm"))


@pytest.fixture(scope="module")
def groups512(testdata):
    groups, yb, xb = TE._extract_all_groups(_image(testdata, "gradient512"),
                                            TE.ImageDim(512, 512))
    return groups, yb, xb


@jax.jit
def _jax_front(groups, yb, xb):
    """The JAX package's decisions for encode_groups' inputs."""
    g = groups.shape[0]
    xyb = PJ.to_xyb(groups)
    qf, masking, raw_qf = PJ.adaptive_quant_field(xyb, 1.0, DISTP.inv_scale)
    coef8 = dct2d(xyb.reshape(g, 3, 32, 8, 32, 8).transpose(0, 1, 2, 4, 3, 5), 8, 8)
    ar = jnp.arange(32)
    valid = (ar[None, :, None] < yb[:, None, None]) & (ar[None, None, :] < xb[:, None, None])
    ytox, ytob = PJ.compute_cmap(coef8, valid)
    strategy, is_first, coef_v, coef_h = PJ.compute_ac_strategy(
        xyb, coef8, qf, masking, ytox, ytob, 1.0, yb, xb)
    raw_qf = PJ.adjust_quant_field(strategy, is_first, raw_qf)
    return dict(xyb=xyb, coef8=coef8, coef_v=coef_v, coef_h=coef_h, strategy=strategy,
                is_first=is_first, raw_qf=raw_qf, ytox=ytox, ytob=ytob, valid=valid)


@pytest.fixture(scope="module")
def front(groups512):
    """The same inputs for both packages' encode_groups: numpy arrays of the
    JAX package's decisions on gradient512's groups."""
    groups, yb, xb = groups512
    return {k: np.asarray(v) for k, v in _jax_front(jnp.asarray(groups), jnp.asarray(yb),
                                                      jnp.asarray(xb)).items()}


_ARGS = ("coef8", "coef_v", "coef_h", "strategy", "is_first", "raw_qf", "ytox", "ytob")


def _port_encode_groups(front, base_ctx):
    t = {k: torch.from_numpy(front[k].copy()) for k in _ARGS + ("valid",)}
    return PF.encode_groups(*(t[k] for k in _ARGS), *SCALARS, t["valid"], TABLES,
                            base_ctx=base_ctx)


def _jax_encode_groups(front, base_ctx):
    j = {k: jnp.asarray(front[k]) for k in ("xyb",) + _ARGS + ("valid",)}
    return [np.asarray(a) for a in PJ.encode_groups(
        j["xyb"], *(j[k] for k in _ARGS), *SCALARS, j["valid"], base_ctx=base_ctx)]


@pytest.fixture(scope="module")
def full_tokens(front):
    """encode_groups with full contexts, in both packages."""
    return _port_encode_groups(front, False), _jax_encode_groups(front, False)


@pytest.mark.parametrize("base_ctx", [False, True])
def test_encode_groups_matches_jax(front, full_tokens, base_ctx):
    got, want = full_tokens if not base_ctx else (
        _port_encode_groups(front, True), _jax_encode_groups(front, True))
    for name, a, b in zip(("tokens_full", "count_full", "quant_dc", "nz_map"), got, want):
        _equal(a, b, name)
    if not base_ctx:  # the full contexts reach past the base-64 range
        assert int((got[0] >> 16).max()) >= 64 and int((got[0] >> 16).max()) < 1980


def test_split_token_cells_matches_jax(front, full_tokens):
    (tok, cnt, _, _), (jtok, jcnt, _, _) = full_tokens
    maps = [front[k] for k in ("strategy", "is_first", "valid")]
    got = PF.split_token_cells(tok, cnt, *(torch.from_numpy(m.copy()) for m in maps))
    want = PJ.split_token_cells(jnp.asarray(jtok), jnp.asarray(jcnt),
                                *(jnp.asarray(m) for m in maps))
    for name, a, b in zip(("tokens", "counts"), got, want):
        _equal(a, b, name)


@pytest.mark.parametrize("cap", ["fits", "cuts"])
def test_compact_token_stream_matches_jax(full_tokens, cap):
    (tok, cnt, _, _), (jtok, jcnt, _, _) = full_tokens
    most = int(cnt.sum(dim=(1, 2, 3)).max())
    c = most + 64 if cap == "fits" else most // 2
    got = PF.compact_token_stream(tok, cnt, c)
    want = PJ.compact_token_stream(jnp.asarray(jtok), jnp.asarray(jcnt), c)
    for name, a, b in zip(("stream", "totals"), got, want):
        _equal(a, b, name)
    assert int(got[1].max()) == most  # totals stay exact past the cap


def test_token_histogram_matches_jax(full_tokens):
    (tok, cnt, _, _), (jtok, jcnt, _, _) = full_tokens
    got = PF.token_histogram(tok, cnt)
    _equal(got, PJ.token_histogram(jnp.asarray(jtok), jnp.asarray(jcnt)), "hist")
    assert int(got.sum()) == int(cnt.sum())


def test_analyze_groups_matches_jax(groups512):
    groups, yb, xb = groups512
    got = PF.analyze_groups(torch.from_numpy(groups), torch.from_numpy(yb),
                            torch.from_numpy(xb), DISTP, TABLES)
    want = PJ.analyze_groups_jax(jnp.asarray(groups), jnp.asarray(yb), jnp.asarray(xb),
                                 **JKW)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k], k)


def _ingest(img, form):
    if form == "f32":
        return img
    if form == "f16":
        return img.astype(np.float16)
    if form == "f16_planes":
        return _split_f16_planes(img.astype(np.float16))
    return linear_to_srgb_u8(img)


@pytest.mark.parametrize("form", ["f32", "f16", "f16_planes", "u8"])
def test_analyze_image_fast_matches_jax(testdata, form):
    img = _ingest(_image(testdata, "odd131x77"), form)
    yb, xb = TE._valid_blocks(TE.ImageDim(131, 77))
    got = PF.analyze_image_fast(torch.from_numpy(np.ascontiguousarray(img)),
                                torch.from_numpy(yb), torch.from_numpy(xb), DISTP, 4096,
                                TABLES)
    want = PJ.analyze_image_fast(jnp.asarray(img), jnp.asarray(yb), jnp.asarray(xb),
                                 cap=4096, **JKW)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k], k)


def test_make_analyze_fn_matches_golden(testdata):
    img = _image(testdata, "photo256")
    got = PF.make_analyze_fn("cpu")(img, 0, 0, DISTP)
    want = TE.analyze_group_numpy(img, 0, 0, DISTP)
    for attr in ("strategy", "is_first", "raw_qf", "ytox", "ytob", "quant_dc", "counts",
                 "tokens"):
        a, b = np.asarray(getattr(got, attr)), np.asarray(getattr(want, attr))
        assert a.dtype == b.dtype and np.array_equal(a, b), attr


# (image, fast, cap): cap 1000 is below every gradient512 group's total,
# so the fast analysis runs twice (the second time at FULL_CAP).
HOST_CASES = {
    "gradient512_fast": ("gradient512", True, 16384),
    "gradient512_full": ("gradient512", False, 16384),
    "gradient512_retry": ("gradient512", True, 1000),
    "odd131x77_fast": ("odd131x77", True, 16384),
    "odd131x77_full": ("odd131x77", False, 16384),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_packed_matches_encode_image_jax(testdata, case):
    name, fast, cap = HOST_CASES[case]
    img = _image(testdata, name)
    mesh = j_make_mesh(jax.devices()[:1]) if fast else None  # None: 8-device mesh
    want = encode_image_jax(img, 1.0, mesh=mesh, fast=fast, cap=cap)
    got = TE.encode_image_host_packed(img, 1.0, fast=fast, cap=cap, device="cpu")
    assert got == want
    assert got == TE.encode_image(img, 1.0)  # the three routes agree


def test_host_packed_retry_runs(testdata, monkeypatch):
    """With cap 1000 the fast analysis runs at 1000 and again at FULL_CAP."""
    caps = []
    real = PF.analyze_image_fast

    def spy(image, yb, xb, distp, cap, tables, kernels=True):
        caps.append(cap)
        return real(image, yb, xb, distp, cap, tables, kernels)

    monkeypatch.setattr(PF, "analyze_image_fast", spy)
    img = _image(testdata, "gradient512")
    assert TE.encode_image_host_packed(img, 1.0, cap=1000, device="cpu") == \
        TE.encode_image(img, 1.0)
    assert caps == [1000, PF.FULL_CAP]


def test_host_packed_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.encode_image_host_packed(np.zeros((3, 16, 16), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF.make_analyze_fn()


@pytest.mark.parametrize("pipeline,size", [("host", 11504), ("numpy", 11506)])
def test_cli_pipelines(testdata, tmp_path, pipeline, size):
    """gradient512 at d=1.0 (host: float16 upload, the CLI's default)."""
    out = tmp_path / "g.jxl"
    src = os.path.join(testdata, "gradient512.pfm")
    assert cli.main([src, str(out), "--pipeline", pipeline, "--device", "cpu", "-q"]) == 0
    data = out.read_bytes()
    assert len(data) == size
    if pipeline == "host":
        img = _image(testdata, "gradient512")
        assert data == TE.encode_image_host_packed(img, 1.0, upload_dtype=np.float16,
                                                   device="cpu")
        assert data == encode_image_jax(img, 1.0, mesh=j_make_mesh(jax.devices()[:1]),
                                        upload_dtype=np.float16)


@pytest.mark.parametrize("flag", ["--static-codes", "--no-cfl", "--no-block-sizes"])
def test_cli_tier_flags_need_device_pipeline(testdata, tmp_path, flag):
    src = os.path.join(testdata, "tiny64.pfm")
    with pytest.raises(SystemExit) as e:
        cli.main([src, str(tmp_path / "t.jxl"), "--pipeline", "host", flag, "--device", "cpu"])
    assert e.value.code == 2
    assert not (tmp_path / "t.jxl").exists()


def test_device_and_host_streams_decode_alike():
    """The 176x272 synthetic of tests/test_device_pack.py's end-to-end
    check: the device-packed and host-packed streams hold the same
    quantized image (decoded pixels bit-identical), their sizes within 5%."""
    rng = np.random.RandomState(3)
    h, w = 176, 272
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx * 0.05) * np.cos(yy * 0.03),
                    0.5 + 0.3 * np.sin((xx + yy) * 0.02),
                    0.4 + 0.2 * np.cos(xx * 0.01)]).astype(np.float32)
    img = np.clip(img + rng.randn(3, h, w).astype(np.float32) * 0.02, 0, 1)
    d_host = TE.encode_image_host_packed(img, 1.0, device="cpu")
    d_dev = TE.encode_image_device(img, 1.0, upload_dtype=None, device="cpu")
    assert abs(len(d_dev) - len(d_host)) / len(d_host) < 0.05
    assert np.array_equal(decode_jxl(d_host), decode_jxl(d_dev))


def test_saturating_quantizer():
    """The extreme input of tests/test_hdr_input.py's slow clamp test."""
    rng = np.random.RandomState(5)
    img = rng.rand(3, 128, 128).astype(np.float32) * 2.0
    img[:, ::2, ::2] = 1e9
    distance = 0.1
    g = TE.analyze_group_numpy(img, 0, 0, compute_distance_params(distance))
    assert int(np.abs(g.quant_dc).max()) == C.DC_VALUE_CLAMP
    vals = (g.tokens & 0xFFFF)[np.arange(64) < g.counts[..., None]]
    assert int(vals.max()) >= 2 * C.AC_COEF_CLAMP - 1  # PackSigned(clamped)

    p_dev = decode_jxl(TE.encode_image_device(img, distance, upload_dtype=None,
                                              device="cpu"))
    p_host = decode_jxl(TE.encode_image_host_packed(img, distance, device="cpu"))
    p_np = decode_jxl(TE.encode_image(img, distance))
    assert np.array_equal(p_dev, p_host)
    rel = np.abs(p_np - p_host) / np.maximum(np.abs(p_np), 1.0)
    assert np.median(rel) < 1e-3 and (rel < 0.2).mean() > 0.999
