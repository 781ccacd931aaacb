"""The port's per-config tools (jxl_tiny_tpu_torch/tools/bench_configs.py and
psnr_file.py) against the JAX package's tools/bench_configs.py and
tools/psnr_file.py, on the CPU.

(a) --ref on the 512x512 goldens gives the bytes, bpp and PSNR (3
    decimals) of the JAX tool's ref_* rows in tools/bench_configs.json,
    through the port's decoder (photo8mp's golden, ~30 s a decode, is left
    out);
(b) the inputs: config 3's tile origins at full size are the JAX
    tool's draws, and on a reduced source its tiles and config 5's
    panorama are the JAX tool's expressions; converting to u8 sRGB first
    gives the same samples;
(c) the card mode, run end to end with device="cpu" on corpus images,
    gives the bytes of the JAX package's encode_image_device /
    encode_batch_device on the float configs and the batch, and rows with
    every field;
(d) psnr_file prints the JAX tool's PSNR for gradient512's golden."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu.encoder import encode_batch_device as jax_batch
from jxl_tiny_tpu.io.color import linear_to_srgb_u8 as jax_to_u8

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch.common import ImageDim
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
from jxl_tiny_tpu_torch.tools import bench_configs as BC
from jxl_tiny_tpu_torch.tools import psnr_file as PF

from test_torch_encode import DIGESTS

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
with open(os.path.join(REPO, "tools", "bench_configs.json")) as _f:
    JAX_ROWS = json.load(_f)
REF_512 = ("config1_512_d1.0", "sweep_512_d0.5", "sweep_512_d1.0", "sweep_512_d2.0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_rows():
    return BC.ref_rows(REF_512)


@pytest.mark.parametrize("key", REF_512)
def test_ref_rows_match_jax_tool(ref_rows, key):
    got, want = ref_rows["ref_" + key], JAX_ROWS["ref_" + key]
    assert (got["bytes"], got["bpp"], got["psnr"]) == (want["bytes"], want["bpp"], want["psnr"])


def _jax_tiles(photo):
    """tools/bench_configs.py:172-181's draw, at full size."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(64):
        y = rng.randint(0, photo.shape[1] - 1024)
        x = rng.randint(0, photo.shape[2] - 1024)
        out.append((y, x))
    return out


def test_tile_origins_are_the_jax_tools():
    assert BC.tile_origins(2160, 3840) == _jax_tiles(np.empty((3, 2160, 3840)))
    assert ImageDim(1024, 1024).num_groups * BC.TILES == 1024


def _source(h=128, w=192):
    return np.ascontiguousarray(BC.load("photo8mp")[:, :h, :w])


def test_inputs_on_a_reduced_source():
    src = _source()
    rng = np.random.RandomState(5)
    tiles = []
    for _ in range(6):  # the JAX tool's loop, 64-pixel tiles
        y = rng.randint(0, src.shape[1] - 64)
        x = rng.randint(0, src.shape[2] - 64)
        tiles.append(src[:, y: y + 64, x: x + 64])
    assert np.array_equal(BC.tiles(src, 6, 64), np.stack(tiles))
    pan = np.concatenate([src, src[:, ::-1]], axis=1)  # the JAX tool's lines
    pan = np.concatenate([pan, pan[:, :, ::-1]], axis=2)
    pan = np.concatenate([pan, pan[:, ::-1]], axis=1)[:, :320, :352]
    assert np.array_equal(BC.panorama(src, 320, 352), pan)
    u8 = linear_to_srgb_u8(src)
    assert np.array_equal(u8, jax_to_u8(src))
    assert np.array_equal(BC.panorama(u8, 320, 352), jax_to_u8(pan))
    assert np.array_equal(BC.tiles(u8, 6, 64), jax_to_u8(np.stack(tiles)))
    # Full size: the JAX tool's 8192x7680 cut of photo8mp's flips.
    assert ImageDim(BC.PANORAMA[1], BC.PANORAMA[0]).num_groups == 960


def test_card_mode_on_the_cpu():
    """Configs 1-5 on corpus images: tiny64 for config 1, odd131x77 (the
    image of tests/test_torch_distances.py) for configs 2-5, three 64x64 u8
    tiles and a 300x262 u8 panorama. The float streams are the JAX
    package's: at d=1.0 through chip_smoke.py's digests (tied to live JAX
    encodes in tests/test_torch_encode.py), at d=0.5 and 2.0 through
    encode_image_device, equal to the JAX package's there
    (tests/test_torch_distances.py). The tiles' batch is the JAX package's
    batch. The u8 panorama is the port's own encode_image_device: the two
    packages linearize u8 samples with pow()s that differ in the last bit,
    and here one quant_dc value sits at such a tie."""
    small, photo = BC.load("tiny64"), BC.load("odd131x77")
    rows, out = BC.measure("cpu", small=small, photo=photo, n_tiles=3, tile=64,
                           pan=(300, 262), repeats=1)
    digests = DIGESTS["default"]
    assert hashlib.sha256(out["config1"]).hexdigest() == digests["tiny64"][1]
    assert hashlib.sha256(out["config4_d1.0"]).hexdigest() == digests["odd131x77"][1]
    for d in (0.5, 2.0):
        assert out[f"config4_d{d}"] == TE.encode_image_device(photo, d, device="cpu"), d
    u8 = linear_to_srgb_u8(photo)
    tiles = BC.tiles(u8, 3, 64)
    assert out["config3"] == jax_batch(tiles, 1.0)
    assert out["config3"] == [TE.encode_image_device(t, 1.0, device="cpu") for t in tiles]
    assert out["config5"] == TE.encode_image_device(BC.panorama(u8, 300, 262), 1.0,
                                                    device="cpu")
    assert set(rows) == {"cpu_config1_512_d1.0", "cpu_config2_8mp_d1.0",
                         "cpu_config3_batch3x64", "cpu_config4_8mp_d0.5",
                         "cpu_config4_8mp_d1.0", "cpu_config4_8mp_d2.0",
                         "cpu_config5_300x262"}
    streams = {"cpu_config1_512_d1.0": out["config1"], "cpu_config5_300x262": out["config5"],
               "cpu_config2_8mp_d1.0": out["config4_d1.0"]}
    streams.update({f"cpu_config4_8mp_d{d}": out[f"config4_d{d}"] for d in BC.DISTANCES})
    for key, data in streams.items():
        assert rows[key]["bytes"] == len(data) and rows[key]["mps"] > 0, key
        assert ("psnr" in rows[key]) == (key != "cpu_config5_300x262"), key
    for key, row in rows.items():
        assert row["measured"]["device"] == "cpu" and row["wall_s"] > 0, key
    assert rows["cpu_config3_batch3x64"]["total_bytes"] == sum(map(len, out["config3"]))
    assert rows["cpu_config3_batch3x64"]["groups"] == 3
    assert (rows["cpu_config5_300x262"]["groups"], rows["cpu_config5_300x262"]["dc_groups"]) \
        == (4, 1)


def test_psnr_file_prints_the_jax_tools_value(capsys):
    jxl = os.path.join(REPO, "testdata", "golden", "gradient512.jxl")
    assert PF.main([jxl, os.path.join(REPO, "testdata", "gradient512.pfm")]) == 0
    want = JAX_ROWS["ref_config1_512_d1.0"]["psnr"]
    assert capsys.readouterr().out == f"{jxl}: psnr={want:.3f}\n"
