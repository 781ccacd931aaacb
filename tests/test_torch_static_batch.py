"""The port's static-tier batch against the JAX package, on the CPU: the
port's encode_batch_device at EncoderConfig(optimize_code=False) on the two
160x200 images of tests/test_config_tiers.py's static batch test gives
the JAX package's per-image static encode_image_device bytes. (The JAX
package's own batch program is not run: its compile takes minutes; the
single-image static program's compile is most of this file's ~70 s.)"""
import numpy as np
import pytest
import torch

from jxl_tiny_tpu.common import EncoderConfig as JaxConfig
from jxl_tiny_tpu.encoder import encode_image_device as jax_encode_image_device

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.decode import decode_jxl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images():
    """tests/test_config_tiers.py::test_static_batch_matches_single_images'."""
    rng = np.random.RandomState(1)
    return [np.clip(rng.rand(3, 160, 200).astype(np.float32) * 0.5 + 0.2 + i * 0.1, 0, 1)
            for i in range(2)]


def test_static_batch_matches_jax_singles():
    imgs = _images()
    want = [jax_encode_image_device(im, 1.0, upload_dtype=None,
                                    config=JaxConfig(optimize_code=False)) for im in imgs]
    got = TE.encode_batch_device(imgs, 1.0, upload_dtype=None,
                                 config=EncoderConfig(optimize_code=False), device="cpu")
    assert [len(b) for b in got] == [len(b) for b in want]
    assert got == want
    for b in got:
        assert decode_jxl(b).shape == (3, 160, 200)
