"""The PyTorch port's encode against the JAX package's encode_image_device,
on the CPU, at the default configuration (AC-strategy search on) and with
fixed 8x8 blocks (EncoderConfig(optimize_block_sizes=False)).

(a) program A from pixels: every output (stream, totals, hists, dc_layout,
    meta) equal to the JAX package's; at the default configuration the
    strategy and is_first maps are also compared on their own
(b) program B + host assembly fed the JAX package's program A outputs:
    codestream bytes identical
(c) the whole port encode from pixels decodes through the JAX package's
    verification decoder at the JAX encode's PSNR (within 0.1 dB) and size
    (within 0.5%); byte identity is asserted where it holds (all five
    images in both configurations at the time of writing: no quad of the
    strategy search flips between the packages on this corpus); byte
    identity also on a 512x512 crop of the 8 MP photograph
(d) no device= and no card: raise
(e) the capability tiers: all five combinations of the JAX package's
    tests/test_config_tiers.py decode above 30 dB; the one-pass static
    tier's candidate picks equal the host argmin and its bytes equal the
    JAX package's

Float stages (ingest, XYB, DCT) are compared at rtol 1e-5 / atol 1e-6:
torch's cbrt/exp/log and XLA's round differently, and XLA contracts a*b+c
into FMA."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jxl_tiny_tpu.common import EncoderConfig as JConfig
from jxl_tiny_tpu.common import compute_distance_params
from jxl_tiny_tpu.decode.decoder import decode_jxl
from jxl_tiny_tpu.encoder import _split_f16_planes
from jxl_tiny_tpu.encoder import encode_image_device as jax_encode
from jxl_tiny_tpu.io.pfm import read_pfm
from jxl_tiny_tpu.ops import pipeline_jax as PJ
from jxl_tiny_tpu.ops.dct_jax import dct2d as jax_dct2d

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch import cli
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.ops.dct import dct2d_8x8
from jxl_tiny_tpu_torch.tables import numpy_tables, tables_from_numpy

from conftest import psnr

CFG = EncoderConfig(optimize_block_sizes=False)
JCFG = JConfig(optimize_block_sizes=False)
IMAGES = ["tiny64", "odd131x77", "photo256", "gradient512", "synth288x160"]
# JAX package sizes at d=1.0 (measured on the CPU), with the AC-strategy
# search off and at the default configuration; the port must reproduce them.
JAX_SIZES = {"tiny64": 444, "odd131x77": 1165, "photo256": 3931, "gradient512": 13484}
JAX_SIZES_DEFAULT = {"tiny64": 394, "odd131x77": 1061, "photo256": 3426,
                     "gradient512": 11680}
TIERS = [(True, True, True), (False, True, True), (True, False, True),
         (True, True, False), (False, False, False)]
KEYS = ("stream", "totals", "hists", "dc_layout", "meta")


def _synth():
    """The 288x160 synthetic of tests/test_config_tiers.py."""
    rng = np.random.RandomState(5)
    h, w = 160, 288
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        0.5 + 0.4 * np.sin(xx * 0.07) * np.cos(yy * 0.05),
        0.5 + 0.3 * np.sin((xx - yy) * 0.03),
        0.4 + 0.2 * np.cos(xx * 0.02),
    ]).astype(np.float32)
    return np.clip(img + rng.randn(3, h, w).astype(np.float32) * 0.03, 0, 1)


def _load(testdata, name):
    if name == "synth288x160":
        return _synth()
    return read_pfm(os.path.join(testdata, f"{name}.pfm"))


def _valid_dims(img):
    h, w = img.shape[1:]
    yb = [-(-min(256, h - gy * 256) // 8) for gy in range(-(-h // 256))
          for _ in range(-(-w // 256))]
    xb = [-(-min(256, w - gx * 256) // 8) for _ in range(-(-h // 256))
          for gx in range(-(-w // 256))]
    return np.array(yb, np.int32), np.array(xb, np.int32)


def _jax_program_a(img, cap, blocks=False):
    """The JAX package's program A, as its DeviceEncodeJob runs it for a
    float image below the f16 threshold (float32 upload)."""
    distp = compute_distance_params(1.0)
    yb, xb = _valid_dims(img)
    out = PJ.analyze_image_packed(
        jnp.asarray(img), jnp.asarray(yb), jnp.asarray(xb),
        distance=float(distp.distance), inv_scale=float(distp.inv_scale),
        scale=float(distp.scale), scale_dc=float(distp.scale_dc),
        x_qm_mul=float(distp.x_qm_mul), cap=cap, cfl=True, blocks=blocks,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _as_port(out):
    """JAX program A outputs of one image -> the port's program A outputs
    (a batch of one: hists [1, 2, 64, 64])."""
    return dict(
        stream=torch.from_numpy(out["stream"].view(np.int32).copy()),
        totals=torch.from_numpy(out["totals"].astype(np.int64)),
        hists=torch.from_numpy(out["hists"].astype(np.int64))[None],
        dc_layout=torch.from_numpy(out["dc_layout"].view(np.int32).copy()),
    )


def _port_program_a(img, monkeypatch, config=None):
    """The port's program A as its job runs it on one image, with hists
    [2, 64, 64] and, under "meta", the per-group maps that its DC layout
    is built from, packed by the JAX package's meta packer (the port's
    program A has no meta output of its own)."""
    maps = []
    real = PL.dc_layout_from_maps

    def spy(*args, **kwargs):
        maps.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(PL, "dc_layout_from_maps", spy)
    job = TE.DeviceEncodeJob([img], 1.0, upload_dtype=None, config=config, device="cpu")
    monkeypatch.undo()
    (m,) = maps
    meta = PJ._pack_meta_u8(*(jnp.asarray(a.numpy()) for a in m))
    return dict(job.out_a, hists=job.out_a["hists"][0],
                meta=torch.from_numpy(np.array(meta)))


def _ref_cache(testdata, jcfg, blocks):
    cache = {}

    def get(name):
        if name not in cache:
            img = _load(testdata, name)
            data = jax_encode(img, 1.0, upload_dtype=None, config=jcfg)
            cache[name] = (img, data, _jax_program_a(img, 32768, blocks))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def ref(testdata):
    """Per image, computed once, fixed 8x8 blocks: (image, JAX bytes, JAX
    program A outputs)."""
    return _ref_cache(testdata, JCFG, False)


@pytest.fixture(scope="module")
def ref_default(testdata):
    """The same at the default configuration."""
    return _ref_cache(testdata, JConfig(), True)


def _assert_program_a_equal(got, want, name):
    assert set(got) == set(KEYS)
    for k in KEYS:
        g = got[k].numpy()
        if k in ("stream", "dc_layout"):
            g = g.view(np.uint32)
        w = want[k]
        assert g.shape == w.shape, k
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), (name, k)


@pytest.mark.parametrize("name", IMAGES)
def test_program_a_matches_jax(ref, name, monkeypatch):
    """(a) Program A on the port's CPU path: every output key equal (meta:
    the per-group maps the DC layout is built from)."""
    img, _, want = ref(name)
    _assert_program_a_equal(_port_program_a(img, monkeypatch, CFG), want, name)


def _strategy_maps(meta):
    """(strategy, is_first) [G,32,32] from program A's packed meta bytes."""
    sf = np.asarray(meta)[:, 7168:8192].reshape(-1, 32, 32)
    return sf & 0x7F, (sf >> 7).astype(bool)


@pytest.mark.parametrize("name", IMAGES)
def test_program_a_default_matches_jax(ref_default, name, monkeypatch):
    """(a) at the default configuration. The strategy maps are compared
    first, quad by quad, so that a flipped decision is named as such
    before the streams that follow from it."""
    img, _, want = ref_default(name)
    got = _port_program_a(img, monkeypatch)
    strat, first = _strategy_maps(got["meta"].numpy())
    jstrat, jfirst = _strategy_maps(want["meta"])
    flipped = np.argwhere((strat != jstrat) | (first != jfirst))
    assert flipped.size == 0, f"{name}: flipped cells (group, by, bx) {flipped[:8]}"
    assert (strat != 0).any(), "the search chose no 16x8 / 8x16 transform"
    _assert_program_a_equal(got, want, name)


@pytest.mark.parametrize("name", IMAGES)
def test_program_b_and_assembly_byte_identical(ref, name, monkeypatch):
    """(b) Program B + host assembly fed the JAX package's program A
    outputs give the JAX package's codestream, byte for byte."""
    img, want, _ = ref(name)
    if name in JAX_SIZES:
        assert len(want) == JAX_SIZES[name]
    calls = []

    def jax_program_a(images, yb, xb, distp, cap, tables, cfl=True, blocks=True,
                      kernels=True):
        assert not blocks and images.shape[0] == 1
        calls.append(cap)
        return _as_port(_jax_program_a(images[0].numpy(), cap))

    monkeypatch.setattr(TE, "analyze_batch_packed", jax_program_a)
    got = TE.encode_image_device(img, 1.0, upload_dtype=None, config=CFG, device="cpu")
    assert calls == [32768]
    assert got == want


@pytest.mark.parametrize("name", IMAGES)
def test_program_b_default_byte_identical(ref_default, name, monkeypatch):
    """(b) at the default configuration (mixed strategies in the stream
    and in the DC layout)."""
    img, want, _ = ref_default(name)
    if name in JAX_SIZES_DEFAULT:
        assert len(want) == JAX_SIZES_DEFAULT[name]

    def jax_program_a(images, yb, xb, distp, cap, tables, cfl=True, blocks=True,
                      kernels=True):
        assert blocks and cap == 32768 and images.shape[0] == 1
        return _as_port(_jax_program_a(images[0].numpy(), cap, blocks=True))

    monkeypatch.setattr(TE, "analyze_batch_packed", jax_program_a)
    assert TE.encode_image_device(img, 1.0, upload_dtype=None, device="cpu") == want


def _assert_decodes_like(img, got, want, name):
    orig = np.clip(img, 0, 1)
    p_got = psnr(np.clip(decode_jxl(got), 0, 1), orig)
    p_want = psnr(np.clip(decode_jxl(want), 0, 1), orig)
    assert abs(p_got - p_want) <= 0.1, (p_got, p_want)
    assert abs(len(got) - len(want)) <= 0.005 * len(want), (len(got), len(want))
    assert got == want, f"{name}: sizes {len(got)} vs {len(want)}"


@pytest.mark.parametrize("name", IMAGES)
def test_port_encode_decodes_like_jax(ref, name):
    """(c) The whole port encode from pixels: PSNR within 0.1 dB of the JAX
    encode's, size within 0.5%, and (today) identical bytes."""
    img, want, _ = ref(name)
    got = TE.encode_image_device(img, 1.0, upload_dtype=None, config=CFG, device="cpu")
    _assert_decodes_like(img, got, want, name)


@pytest.mark.parametrize("name", IMAGES)
def test_port_encode_default_decodes_like_jax(ref_default, name):
    """(c) at the default configuration, EncoderConfig()."""
    img, want, _ = ref_default(name)
    got = TE.encode_image_device(img, 1.0, upload_dtype=None, device="cpu")
    _assert_decodes_like(img, got, want, name)


def test_photo8mp_crop_matches_jax(testdata):
    """(c) on a 512x512 crop of the 8 MP photograph that chip_smoke.py
    encodes on the card: at the default configuration the port's bytes
    equal the JAX package's, and the search saves 6.6% over fixed 8x8
    blocks on this content (13% on photo256 and gradient512)."""
    img = read_pfm(os.path.join(testdata, "photo8mp.pfm"))
    crop = np.ascontiguousarray(img[:, 512:1024, 1024:1536])
    del img
    want = jax_encode(crop, 1.0, upload_dtype=None, config=JConfig())
    got = TE.encode_image_device(crop, 1.0, upload_dtype=None, device="cpu")
    assert got == want and len(got) == 12599
    fixed = TE.encode_image_device(crop, 1.0, upload_dtype=None, config=CFG, device="cpu")
    assert len(fixed) == 13493


@pytest.mark.parametrize("kind", ["float32", "float16", "uint8"])
def test_ingest_matches_jax(testdata, kind):
    """extract_groups_device for each upload type: float32 and float16 exact
    (the JAX package's f16 byte-plane split carries the same values); u8
    sRGB linearization within float tolerance."""
    img = read_pfm(os.path.join(testdata, "odd131x77.pfm"))
    if kind == "uint8":
        up = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        jax_in = up
    elif kind == "float16":
        up = img.astype(np.float16)
        jax_in = _split_f16_planes(up)
    else:
        up = jax_in = img
    want = np.asarray(PJ.extract_groups_device(jnp.asarray(jax_in)))
    got = PL.extract_groups_device(torch.from_numpy(up)).numpy()
    if kind == "uint8":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(got, want)


def test_xyb_dct_cmap_match_jax(testdata):
    """Float stages within tolerance; the chroma-from-luma decisions exact."""
    img = read_pfm(os.path.join(testdata, "gradient512.pfm"))
    groups = PL.extract_groups_device(torch.from_numpy(img))
    g = groups.shape[0]
    xyb = PL.to_xyb(groups)
    jxyb = np.asarray(PJ.to_xyb(jnp.asarray(groups.numpy())))
    np.testing.assert_allclose(xyb.numpy(), jxyb, rtol=1e-5, atol=1e-6)
    blocks = xyb.reshape(g, 3, 32, 8, 32, 8).permute(0, 1, 2, 4, 3, 5)
    tables = tables_from_numpy(numpy_tables(), "cpu")
    coef = dct2d_8x8(blocks, tables.dct8)
    jcoef = np.asarray(jax_dct2d(jnp.asarray(blocks.numpy()), 8, 8))
    np.testing.assert_allclose(coef.numpy(), jcoef, rtol=1e-5, atol=1e-6)
    valid = torch.ones((g, 32, 32), dtype=torch.bool)
    for got, want in zip(PL.compute_cmap(coef, valid, tables),
                         PJ.compute_cmap(jnp.asarray(jcoef), jnp.asarray(valid.numpy()))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_no_device_without_card_raises(testdata, monkeypatch):
    """(d) device=None means the card; without one the encode raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = read_pfm(os.path.join(testdata, "tiny64.pfm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.encode_image_device(img, 1.0, config=CFG)


@pytest.mark.parametrize("code,cfl,blocks", TIERS)
def test_tier_combinations_decode(code, cfl, blocks):
    """(e) Every capability tier runs and decodes above 30 dB (the cases
    and the bound of the JAX package's tests/test_config_tiers.py)."""
    img = _synth()
    cfg = EncoderConfig(optimize_code=code, optimize_chroma_from_luma=cfl,
                        optimize_block_sizes=blocks)
    data = TE.encode_image_device(img, 1.0, upload_dtype=None, config=cfg, device="cpu")
    p = psnr(np.clip(decode_jxl(data), 0, 1), np.clip(img, 0, 1))
    assert p > 30.0, f"PSNR {p:.2f} too low for tier {cfg}"


@pytest.mark.parametrize("name", ["tiny64", "synth288x160"])
def test_static_tier_matches_jax(testdata, name):
    """(e) One-pass static codes: bytes equal to the JAX package's."""
    img = _load(testdata, name)
    want = jax_encode(img, 1.0, upload_dtype=None, config=JConfig(optimize_code=False))
    got = TE.encode_image_device(img, 1.0, upload_dtype=None, device="cpu",
                                 config=EncoderConfig(optimize_code=False))
    _assert_decodes_like(img, got, want, name)


@pytest.mark.parametrize("name", ["synth288x160", "photo256"])
def test_static_candidate_selection_matches_host(testdata, name):
    """(e) The device's candidate picks, reported at the end of `small`,
    equal the host's int64 argmin over the two-pass job's histograms, and
    ACGlobal / DCGlobal serialize those candidates."""
    from jxl_tiny_tpu_torch.entropy.entropy_write import load_static_codes

    img = _load(testdata, name)
    job = TE.DeviceEncodeJob([img], 1.0, upload_dtype=None, device="cpu",
                             config=EncoderConfig(optimize_code=False))
    (data,) = job.result()
    small = job._small_sync()
    k_ac, k_dc = int(small[-2]), int(small[-1])
    two = TE.DeviceEncodeJob([img], 1.0, upload_dtype=None, device="cpu")
    hists = two.out_a["hists"].numpy()[0]
    sc = load_static_codes()
    for k_dev, hist, depths in ((k_ac, hists[0], sc.ac_depths), (k_dc, hists[1], sc.dc_depths)):
        costs = (hist[None] * depths.astype(np.int64)).sum(axis=(1, 2))
        assert k_dev == int(np.argmin(costs)), (k_dev, costs)
    assert len(sc.ac_codes) > 1 and len(sc.dc_codes) > 1
    assert job.full_codes[0] is sc.ac_codes[k_ac] and job.dc_codes[0] is sc.dc_codes[k_dc]
    assert np.array_equal(small[-2 - len(two.out_a["totals"]):-2], two.out_a["totals"].numpy())
    (two_pass,) = two.result()
    assert len(two_pass) < len(data) < 1.25 * len(two_pass)
    assert decode_jxl(data) is not None


def test_static_tier_cap_retry(testdata):
    """(e) A token cap that a group overflows: the one-pass job re-runs its
    combined program at the next bucket and gives the same bytes."""
    img = _load(testdata, "photo256")
    cfg = EncoderConfig(optimize_code=False)
    want = TE.encode_image_device(img, 1.0, upload_dtype=None, config=cfg, device="cpu")
    job = TE.DeviceEncodeJob([img], 1.0, upload_dtype=None, cap=1024, config=cfg, device="cpu")
    assert job.result() == [want] and job.cap == 32768


def test_cli(testdata, tmp_path):
    """The CLI at the default configuration, with --no-block-sizes and with
    --static-codes."""
    src = os.path.join(testdata, "tiny64.pfm")
    out = tmp_path / "t.jxl"
    base = [src, str(out), "-d", "1.0", "--device", "cpu", "-q"]
    for flags, size in (([], JAX_SIZES_DEFAULT["tiny64"]),
                        (["--no-block-sizes"], JAX_SIZES["tiny64"]),
                        (["--static-codes"], 1058)):
        assert cli.main(base + flags) == 0
        assert len(out.read_bytes()) == size, flags
