"""The float32 -> float16 ingest: transfer.round_to_f16 against numpy.

On the card, float32 pixels that travel as float16 go up as float32 and
are rounded there (transfer.upload_pixels, span ingest.round) instead of
by numpy's cast on the host. The rounding must be numpy's, bit for bit,
so that the card gets the same pixels and the codestream the same bytes:

- on the CPU, round_to_f16 against `astype(np.float16)` on every finite
  float16, every halfway point between neighbours (ties to even), one
  float32 ulp either side of each, the subnormal range and below it, the
  overflow edge, +-inf and +-0, each with its negatives; NaN stays NaN;
- on the CPU, upload_pixels still returns astype's tensor;
- on the card (`gpu`), photo8mp's upload equals astype's pixels, its
  encode equals the encode of the float16 image rounded by numpy, and a
  512x512 float32 image (uploaded as float32) rounds nothing on the card.

No JAX: the card's machine has none."""
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.transfer import round_to_f16, upload_pixels
from jxl_tiny_tpu_torch.utils import StageTimer

TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "testdata")
F32 = np.float32


def _finite_f16():
    """Every finite float16 as float32 (exact), -0 and +0 included."""
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    return h[np.isfinite(h)].astype(F32)


def _halfway():
    """The midpoint of each pair of neighbouring non-negative float16
    values, exact in float32 (12 significant bits), and the one between
    the largest float16 and the next power of two's step (65520)."""
    v = np.unique(_finite_f16()[_finite_f16() >= 0]).astype(np.float64)
    mids = (v[:-1] + v[1:]) / 2
    return np.append(mids, 65520.0).astype(F32)


def _either_side(x):
    with np.errstate(over="ignore"):  # the largest float32's neighbour is inf
        return np.concatenate([np.nextafter(x, F32(np.inf)), np.nextafter(x, F32(-np.inf))])


def _subnormal_and_below():
    """float32 values from float32's own subnormals up to float16's
    smallest normal (2**-14), the smallest float16 subnormal (2**-24), half
    of it (a tie that rounds to 0) and their neighbours."""
    span = np.geomspace(1e-45, 2.0 ** -14, 20000).astype(F32)
    edges = np.array([2.0 ** -24, 2.0 ** -25, 1.5 * 2.0 ** -24, 2.0 ** -14], F32)
    return np.concatenate([span, edges, _either_side(edges)])


def _overflow_edge():
    edges = np.array([65504.0, 65519.996, 65520.0, 65536.0, 1e6, 3.4028235e38], F32)
    return np.concatenate([edges, _either_side(edges)])


CASES = {
    "finite_f16": _finite_f16,
    "halfway": _halfway,
    "ulp_either_side": lambda: _either_side(np.concatenate([_finite_f16(), _halfway()])),
    "subnormal_and_below": _subnormal_and_below,
    "overflow_edge": _overflow_edge,
    "inf_and_zero": lambda: np.array([np.inf, 0.0], F32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_round_to_f16_is_numpys(case):
    x = CASES[case]()
    x = np.concatenate([x, -x])
    got = round_to_f16(torch.from_numpy(x))
    assert got.dtype == torch.float16 and got.shape == x.shape
    with np.errstate(over="ignore"):  # past 65520 numpy warns as it gives inf
        want = x.astype(np.float16).view(np.uint16)
    diff = got.numpy().view(np.uint16) != want
    assert not diff.any(), (int(diff.sum()), x[diff][:8])


def test_round_to_f16_keeps_nan():
    nan = np.array([np.nan, -np.nan], F32)
    payload = np.array([0x7FC00001, 0xFFC12345, 0x7F800001], np.uint32).view(F32)
    x = np.concatenate([nan, payload])
    assert np.isnan(round_to_f16(torch.from_numpy(x)).numpy()).all()


@pytest.mark.parametrize("batch", [False, True])
def test_cpu_upload_is_astype(batch):
    """Off the card the upload stays astype's: an 8 MP float32 image goes
    as float16 (_upload_dtype) and upload_pixels returns numpy's pixels,
    one image or a list, and opens no span."""
    rng = np.random.default_rng(21)
    imgs = [rng.standard_normal((3, 24, 40)).astype(F32) * 300 for _ in range(2)]
    dtype = TE._upload_dtype(np.dtype(F32), 3840 * 2160, np.float16)
    assert dtype == np.float16
    timer = StageTimer()
    with timer.collect():
        got = upload_pixels(imgs if batch else imgs[0], dtype, torch.device("cpu"))
    want = np.stack(imgs).astype(np.float16) if batch else imgs[0].astype(np.float16)
    assert got.dtype == torch.float16 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint16), want.view(np.uint16))
    assert timer.calls == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def photo():
    return read_pfm(os.path.join(TESTDATA, "photo8mp.pfm"))


@pytest.mark.gpu
def test_card_upload_is_astype(cuda, photo):
    assert photo.dtype == F32
    timer = StageTimer()
    with timer.collect():
        up = upload_pixels(photo, np.dtype(np.float16), cuda)
    torch.cuda.synchronize()
    want = torch.from_numpy(photo.astype(np.float16))
    assert up.dtype == torch.float16 and up.is_cuda
    assert torch.equal(up.cpu().view(torch.int16), want.view(torch.int16))
    assert timer.calls["ingest.round"] == 1 and timer.calls["ingest.convert"] == 1


@pytest.mark.gpu
def test_card_encode_f32_equals_f16(cuda, photo):
    """The float32 image, rounded on the card, against the same image
    rounded by numpy, which takes the float16 copy on the host."""
    timer = StageTimer()
    with timer.collect():
        got = TE.encode_image_device(photo, 1.0)
    assert timer.calls["ingest.round"] == 1
    timer = StageTimer()
    with timer.collect():
        want = TE.encode_image_device(photo.astype(np.float16), 1.0)
    assert "ingest.round" not in timer.calls
    assert got == want


@pytest.mark.gpu
def test_card_small_f32_rounds_nothing(cuda):
    """512x512 is under F16_AUTO_F32_PIXELS: it goes up as float32."""
    img = read_pfm(os.path.join(TESTDATA, "gradient512.pfm"))
    timer = StageTimer()
    with timer.collect():
        TE.encode_image_device(img, 1.0)
    assert timer.calls["ingest.convert"] == 1 and "ingest.round" not in timer.calls
