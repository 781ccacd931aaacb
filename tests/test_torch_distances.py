"""The port's encode against the JAX package's at inputs no other port test
reaches, on the CPU: distances other than 1.0 (d=0.5 and d=2.0 change the
X quant-matrix scale, the EPF iterations and the strategy search's slope)
and HDR float input above 1.0 (the 128x192 image of the JAX package's
tests/test_hdr_input.py). Codestream bytes must be identical."""
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu.decode.decoder import decode_jxl
from jxl_tiny_tpu.encoder import encode_image_device as jax_encode
from jxl_tiny_tpu.io.pfm import read_pfm

from jxl_tiny_tpu_torch.encoder import encode_image_device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's CPU encodes: the suite runs
    several test processes on a few cores at once, and torch's own thread
    pool in each would oversubscribe them (an encode took ~50x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hdr_image():
    """tests/test_hdr_input.py's image: values up to ~4."""
    rng = np.random.RandomState(21)
    h, w = 128, 192
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            2.5 + 1.5 * np.sin(xx * 0.05),
            1.8 + 1.2 * np.cos(yy * 0.04),
            0.9 + 0.8 * np.sin((xx + yy) * 0.02),
        ]
    ).astype(np.float32)
    return np.maximum(img + rng.randn(3, h, w).astype(np.float32) * 0.05, 0)


@pytest.mark.parametrize("distance", [0.5, 2.0])
def test_distance_matches_jax(testdata, distance):
    img = read_pfm(os.path.join(testdata, "odd131x77.pfm"))
    want = jax_encode(img, distance, upload_dtype=None)
    got = encode_image_device(img, distance, upload_dtype=None, device="cpu")
    assert got == want, (distance, len(got), len(want))


def test_hdr_input_matches_jax():
    img = _hdr_image()
    assert img.max() > 2.0
    want = jax_encode(img, 1.0, upload_dtype=None)
    got = encode_image_device(img, 1.0, upload_dtype=None, device="cpu")
    assert got == want, (len(got), len(want))
    dec = np.asarray(decode_jxl(got))
    rel = np.abs(dec - img) / np.maximum(img, 0.5)
    assert np.median(rel) < 0.05
