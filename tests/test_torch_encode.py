"""The PyTorch port's encode (two-pass, fixed 8x8 blocks) against the JAX
package's encode_image_device(..., EncoderConfig(optimize_block_sizes=False)),
on the CPU.

(a) program A from pixels: every output (stream, totals, hists, dc_layout,
    meta) equal to the JAX package's
(b) program B + host assembly fed the JAX package's program A outputs:
    codestream bytes identical
(c) the whole port encode from pixels decodes through the JAX package's
    verification decoder at the JAX encode's PSNR (within 0.1 dB) and size
    (within 0.5%); byte identity is asserted where it holds (all five
    images at the time of writing)
(d) no device= and no card: raise; (e) the AC-strategy search and the
    one-pass tier: NotImplementedError

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
# JAX package sizes at d=1.0 with the AC-strategy search off (measured on
# the CPU); the port must reproduce them.
JAX_SIZES = {"tiny64": 444, "odd131x77": 1165, "photo256": 3931, "gradient512": 13484}
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


def _jax_program_a(img, cap):
    """The JAX package's program A, as its DeviceEncodeJob runs it for a
    float image below the f16 threshold (float32 upload)."""
    distp = compute_distance_params(1.0)
    yb, xb = _valid_dims(img)
    out = PJ.analyze_image_packed(
        jnp.asarray(img), jnp.asarray(yb), jnp.asarray(xb),
        distance=float(distp.distance), inv_scale=float(distp.inv_scale),
        scale=float(distp.scale), scale_dc=float(distp.scale_dc),
        x_qm_mul=float(distp.x_qm_mul), cap=cap, cfl=True, blocks=False,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _as_port(out):
    """JAX program A outputs -> the port's tensor types."""
    return dict(
        stream=torch.from_numpy(out["stream"].view(np.int32).copy()),
        totals=torch.from_numpy(out["totals"].astype(np.int64)),
        hists=torch.from_numpy(out["hists"].astype(np.int64)),
        dc_layout=torch.from_numpy(out["dc_layout"].view(np.int32).copy()),
        meta=torch.from_numpy(out["meta"].copy()),
    )


@pytest.fixture(scope="module")
def ref(testdata):
    """Per image, computed once: (image, JAX bytes, JAX program A outputs)."""
    cache = {}

    def get(name):
        if name not in cache:
            img = _load(testdata, name)
            data = jax_encode(img, 1.0, upload_dtype=None, config=JCFG)
            cache[name] = (img, data, _jax_program_a(img, 32768))
        return cache[name]

    return get


@pytest.mark.parametrize("name", IMAGES)
def test_program_a_matches_jax(ref, name):
    """(a) Program A on the port's CPU path: every output key equal."""
    img, _, want = ref(name)
    job = TE.DeviceEncodeJob(img, 1.0, upload_dtype=None, config=CFG, device="cpu")
    got = job.out_a
    assert set(got) == set(KEYS)
    for k in KEYS:
        g = got[k].numpy()
        if k in ("stream", "dc_layout"):
            g = g.view(np.uint32)
        w = want[k]
        assert g.shape == w.shape, k
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), (name, k)


@pytest.mark.parametrize("name", IMAGES)
def test_program_b_and_assembly_byte_identical(ref, name, monkeypatch):
    """(b) Program B + host assembly fed the JAX package's program A
    outputs give the JAX package's codestream, byte for byte."""
    img, want, _ = ref(name)
    if name in JAX_SIZES:
        assert len(want) == JAX_SIZES[name]
    calls = []

    def jax_program_a(image, yb, xb, distp, cap, tables, cfl=True, kernels=True):
        calls.append(cap)
        return _as_port(_jax_program_a(image.numpy(), cap))

    monkeypatch.setattr(TE, "analyze_image_packed", jax_program_a)
    got = TE.encode_image_device(img, 1.0, upload_dtype=None, config=CFG, device="cpu")
    assert calls == [32768]
    assert got == want


@pytest.mark.parametrize("name", IMAGES)
def test_port_encode_decodes_like_jax(ref, name):
    """(c) The whole port encode from pixels: PSNR within 0.1 dB of the JAX
    encode's, size within 0.5%, and (today) identical bytes."""
    img, want, _ = ref(name)
    got = TE.encode_image_device(img, 1.0, upload_dtype=None, config=CFG, device="cpu")
    orig = np.clip(img, 0, 1)
    p_got = psnr(np.clip(decode_jxl(got), 0, 1), orig)
    p_want = psnr(np.clip(decode_jxl(want), 0, 1), orig)
    assert abs(p_got - p_want) <= 0.1, (p_got, p_want)
    assert abs(len(got) - len(want)) <= 0.005 * len(want), (len(got), len(want))
    assert got == want, f"{name}: sizes {len(got)} vs {len(want)}"


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
    coef = dct2d_8x8(blocks, tables_from_numpy(numpy_tables(), "cpu").dct8)
    jcoef = np.asarray(jax_dct2d(jnp.asarray(blocks.numpy()), 8, 8))
    np.testing.assert_allclose(coef.numpy(), jcoef, rtol=1e-5, atol=1e-6)
    valid = torch.ones((g, 32, 32), dtype=torch.bool)
    for got, want in zip(PL.compute_cmap(coef, valid),
                         PJ.compute_cmap(jnp.asarray(jcoef), jnp.asarray(valid.numpy()))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_no_device_without_card_raises(testdata, monkeypatch):
    """(d) device=None means the card; without one the encode raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = read_pfm(os.path.join(testdata, "tiny64.pfm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.encode_image_device(img, 1.0, config=CFG)


@pytest.mark.parametrize(
    "config",
    [EncoderConfig(), EncoderConfig(optimize_block_sizes=False, optimize_code=False)],
    ids=["block_sizes", "static_codes"],
)
def test_unported_tiers_raise(testdata, config):
    """(e) The AC-strategy search and the one-pass tier are explicit
    limits of this port, not fallbacks."""
    img = read_pfm(os.path.join(testdata, "tiny64.pfm"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.encode_image_device(img, 1.0, config=config, device="cpu")


def test_cli(testdata, tmp_path, capsys):
    """The CLI encodes with --no-block-sizes and refuses without it."""
    src = os.path.join(testdata, "tiny64.pfm")
    out = tmp_path / "t.jxl"
    assert cli.main([src, str(out), "-d", "1.0", "--no-block-sizes",
                     "--device", "cpu", "-q"]) == 0
    assert len(out.read_bytes()) == JAX_SIZES["tiny64"]
    assert cli.main([src, str(tmp_path / "u.jxl"), "--device", "cpu", "-q"]) == 1
    assert "--no-block-sizes" in capsys.readouterr().err
