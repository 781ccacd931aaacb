"""The port's psnr_file tool (jxl_tiny_tpu_torch/tools/psnr_file.py) and
chip_smoke.py's builders of config 3's and config 5's inputs, against the
JAX package's tools/bench_configs.py and tools/psnr_file.py, on the CPU.

(a) the 512x512 goldens' bytes, bpp and PSNR (3 decimals) through the
    port's decoder and psnr_file.psnr are those of the JAX tool's ref_* rows
    in tools/bench_configs.json (photo8mp's golden, ~30 s a decode, is left
    out);
(b) the inputs: config 3's tile origins at full size are the JAX
    tool's draws, and on a reduced source its tiles and config 5's
    panorama are the JAX tool's expressions; converting to u8 sRGB first
    gives the same samples;
(c) psnr_file prints the JAX tool's PSNR for gradient512's golden."""
import json
import os

import numpy as np
import pytest

from jxl_tiny_tpu.io.color import linear_to_srgb_u8 as jax_to_u8

from jxl_tiny_tpu_torch.common import ImageDim
from jxl_tiny_tpu_torch.decode import decode_jxl
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
from jxl_tiny_tpu_torch.tools import psnr_file as PF

from test_torch_encode import _chip_smoke

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
with open(os.path.join(REPO, "tools", "bench_configs.json")) as _f:
    JAX_ROWS = json.load(_f)
# The JAX tool's 512x512 reference rows: (key, golden stream, source image).
REF_512 = (
    ("config1_512_d1.0", "gradient512.jxl", "gradient512"),
    ("sweep_512_d0.5", "gradient512_d0.5.jxl", "gradient512"),
    ("sweep_512_d1.0", "gradient512.jxl", "gradient512"),
    ("sweep_512_d2.0", "gradient512_d2.0.jxl", "gradient512"),
)
CS = _chip_smoke()


@pytest.mark.parametrize("key,golden,name", REF_512, ids=[k for k, _, _ in REF_512])
def test_ref_rows_match_jax_tool(key, golden, name):
    img = CS.load(name)
    with open(os.path.join(REPO, "testdata", "golden", golden), "rb") as f:
        data = f.read()
    bpp = round(8 * len(data) / (img.shape[1] * img.shape[2]), 4)
    got = (len(data), bpp, round(PF.psnr(decode_jxl(data), img), 3))
    want = JAX_ROWS["ref_" + key]
    assert got == (want["bytes"], want["bpp"], want["psnr"])


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
    assert CS.tile_origins(2160, 3840) == _jax_tiles(np.empty((3, 2160, 3840)))
    assert ImageDim(1024, 1024).num_groups * CS.TILES == 1024


def _source(h=128, w=192):
    return np.ascontiguousarray(CS.load("photo8mp")[:, :h, :w])


def test_inputs_on_a_reduced_source():
    src = _source()
    rng = np.random.RandomState(5)
    tiles = []
    for _ in range(6):  # the JAX tool's loop, 64-pixel tiles
        y = rng.randint(0, src.shape[1] - 64)
        x = rng.randint(0, src.shape[2] - 64)
        tiles.append(src[:, y: y + 64, x: x + 64])
    assert np.array_equal(CS.tiles(src, 6, 64), np.stack(tiles))
    pan = np.concatenate([src, src[:, ::-1]], axis=1)  # the JAX tool's lines
    pan = np.concatenate([pan, pan[:, :, ::-1]], axis=2)
    pan = np.concatenate([pan, pan[:, ::-1]], axis=1)[:, :320, :352]
    assert np.array_equal(CS.panorama(src, 320, 352), pan)
    u8 = linear_to_srgb_u8(src)
    assert np.array_equal(u8, jax_to_u8(src))
    assert np.array_equal(CS.panorama(u8, 320, 352), jax_to_u8(pan))
    assert np.array_equal(CS.tiles(u8, 6, 64), jax_to_u8(np.stack(tiles)))
    # Full size: the JAX tool's 8192x7680 cut of photo8mp's flips.
    assert ImageDim(CS.PANORAMA[1], CS.PANORAMA[0]).num_groups == 960


def test_psnr_file_prints_the_jax_tools_value(capsys):
    jxl = os.path.join(REPO, "testdata", "golden", "gradient512.jxl")
    assert PF.main([jxl, os.path.join(REPO, "testdata", "gradient512.pfm")]) == 0
    want = JAX_ROWS["ref_config1_512_d1.0"]["psnr"]
    assert capsys.readouterr().out == f"{jxl}: psnr={want:.3f}\n"
