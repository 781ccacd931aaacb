"""The port's numpy golden model (jxl_tiny_tpu_torch/ref/) and its numpy
encode path (encoder.encode_image, analyze_group_numpy) against the JAX
package's, on the CPU. Both are numpy, so every comparison is exact: the
stages of the golden model on photo256's first group, each DCT helper on
seeded blocks, the group analysis attribute by attribute, and the
codestream bytes of the numpy path on four test images."""
import os

import numpy as np
import pytest

from jxl_tiny_tpu.common import compute_distance_params as j_distp
from jxl_tiny_tpu.encoder import analyze_group_numpy as j_analyze
from jxl_tiny_tpu.encoder import encode_image as j_encode
from jxl_tiny_tpu.io.pfm import read_pfm
from jxl_tiny_tpu.ref import dct_np as JD
from jxl_tiny_tpu.ref import group_np as JG
from jxl_tiny_tpu.ref import pipeline_np as JP

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch.common import compute_distance_params
from jxl_tiny_tpu_torch.ref import dct_np as TD
from jxl_tiny_tpu_torch.ref import group_np as TG
from jxl_tiny_tpu_torch.ref import pipeline_np as TP

# The numpy path's sizes at d=1.0 (the JAX package's encode_image on the
# CPU): the port must reproduce the bytes, so the sizes too.
SIZES = {"tiny64": 394, "odd131x77": 994, "photo256": 3399, "gradient512": 11506}
ATTRS = ["strategy", "is_first", "raw_qf", "ytox", "ytob", "quant_dc", "counts", "tokens"]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), f"{what}: {(a != b).sum()} elements differ"


@pytest.fixture(scope="module")
def photo256(testdata):
    return read_pfm(os.path.join(testdata, "photo256.pfm"))


@pytest.fixture(scope="module")
def group0(photo256):
    """photo256's group 0 as XYB, with its AQ field and CfL maps (from the
    JAX package's golden model; the stage tests check the port's)."""
    xyb = JP.to_xyb(TE._extract_group(photo256, 0, 0))
    qf, masking, raw_qf = JP.compute_adaptive_quant_field(xyb, 1.0, j_distp(1.0).inv_scale)
    ytox, ytob = JP.compute_cmap(xyb, 32, 32)
    return xyb, qf, masking, raw_qf, ytox, ytob


def test_to_xyb(photo256):
    img = TE._extract_group(photo256, 0, 0)
    _equal(TP.to_xyb(img), JP.to_xyb(img), "to_xyb")


@pytest.mark.parametrize("striped", [False, True])
def test_adaptive_quant_field(group0, striped):
    xyb = group0[0]
    inv = compute_distance_params(1.0).inv_scale
    if striped:
        got = TP.compute_adaptive_quant_field_striped(xyb, 1.0, inv)
        want = JP.compute_adaptive_quant_field_striped(xyb, 1.0, inv)
    else:
        got = TP.compute_adaptive_quant_field(xyb, 1.0, inv)
        want = JP.compute_adaptive_quant_field(xyb, 1.0, inv)
    for name, a, b in zip(("qf", "masking", "raw_qf"), got, want):
        _equal(a, b, name)


@pytest.mark.parametrize("blocks", [(32, 32), (10, 17)])
def test_compute_cmap(group0, blocks):
    yb, xb = blocks
    got = TP.compute_cmap(group0[0], xb, yb)
    want = JP.compute_cmap(group0[0], xb, yb)
    for name, a, b in zip(("ytox", "ytob"), got, want):
        _equal(a, b, name)


def test_ac_strategy_and_adjust(group0):
    xyb, qf, masking, raw_qf, ytox, ytob = group0
    got = TP.compute_ac_strategy(xyb, qf, masking, ytox, ytob, 1.0, 32, 32)
    want = JP.compute_ac_strategy(xyb, qf, masking, ytox, ytob, 1.0, 32, 32)
    for name, a, b in zip(("strategy", "is_first"), got, want):
        _equal(a, b, name)
    assert {1, 2} <= set(np.unique(got[0]).tolist())  # both two-cell transforms
    _equal(TP.adjust_quant_field(*got, raw_qf), JP.adjust_quant_field(*want, raw_qf),
           "adjust_quant_field")


def test_encode_group(group0):
    xyb, qf, masking, raw_qf, ytox, ytob = group0
    strategy, is_first = JP.compute_ac_strategy(xyb, qf, masking, ytox, ytob, 1.0, 32, 32)
    raw_qf = JP.adjust_quant_field(strategy, is_first, raw_qf)
    d = compute_distance_params(1.0)
    args = (xyb, strategy, is_first, raw_qf, ytox, ytob, d.scale, d.scale_dc, d.x_qm_mul,
            32, 32)
    got, want = TG.encode_group(*args), JG.encode_group(*args)
    for name in ("tokens", "counts", "quant_dc", "nzeros"):
        _equal(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (3, 16, 8), (3, 8, 16)])
def test_dct_helpers(shape):
    """dct2d_blocks / idct2d_blocks on seeded blocks of every transform
    size, and the 16x8 / 8x16 recombinations from 8x8 DCTs."""
    rng = np.random.RandomState(3)
    px = rng.rand(*shape).astype(np.float32)
    coef = TD.dct2d_blocks(px)
    _equal(coef, JD.dct2d_blocks(px), "dct2d_blocks")
    r, c = shape[-2:]
    _equal(TD.idct2d_blocks(coef, r, c), JD.idct2d_blocks(coef, r, c), "idct2d_blocks")
    a = rng.rand(4, 8, 8).astype(np.float32)
    b = rng.rand(4, 8, 8).astype(np.float32)
    _equal(TD.dct16x8_from_8(a, b), JD.dct16x8_from_8(a, b), "dct16x8_from_8")
    _equal(TD.dct8x16_from_8(a, b), JD.dct8x16_from_8(a, b), "dct8x16_from_8")


def test_analyze_group_numpy_matches_jax(photo256):
    gt = TE.analyze_group_numpy(photo256, 0, 0, compute_distance_params(1.0))
    gj = j_analyze(photo256, 0, 0, j_distp(1.0))
    for attr in ATTRS:
        _equal(getattr(gt, attr), getattr(gj, attr), attr)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_encode_image_matches_jax(testdata, name):
    img = read_pfm(os.path.join(testdata, f"{name}.pfm"))
    got = TE.encode_image(img, 1.0)
    assert got == j_encode(img, 1.0)
    assert len(got) == SIZES[name]


def test_encode_file(testdata, tmp_path):
    out = tmp_path / "odd.jxl"
    n = TE.encode_file(os.path.join(testdata, "odd131x77.pfm"), str(out))
    assert n == SIZES["odd131x77"] == len(out.read_bytes())
