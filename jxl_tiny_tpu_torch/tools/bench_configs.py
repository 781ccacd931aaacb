"""BASELINE.md's per-config contract, measured for the port: the
counterpart of the JAX package's tools/bench_configs.py.

    python -m jxl_tiny_tpu_torch.tools.bench_configs --ref [--out FILE]
    python -m jxl_tiny_tpu_torch.tools.bench_configs [--out FILE] [--streams DIR] [--device cpu]

--ref (host only): the reference rows from the cjxl_tiny goldens in
testdata/golden/: bytes, bpp and PSNR through the port's decoder.

Without --ref: configs 1-5 encoded on the card (device=None; --device cpu
runs the plain torch versions on the CPU instead):
  1. gradient512 at d=1.0;
  2. photo8mp at d=1.0 (the d=1.0 row of config 4);
  3. 64 tiles of 1024x1024, u8 sRGB, drawn from photo8mp with
     np.random.RandomState(5), in one encode_batch_device (1,024 groups);
  4. photo8mp at d = 0.5, 1.0 and 2.0;
  5. the 8192x7680 u8 sRGB panorama of photo8mp's flips (960 groups in 16
     DC groups), through encode_image_device.
Each row holds bytes, bpp, the warm wall (median of 3, host clock; each
encode ends with its bytes on the host, so with its device work done) and
MP/s (config 3: the batch's aggregate). Single-image rows add the device
times of program A and program B (utils/profiling.encode_report: CUDA
events, nothing subtracted); configs 1 and 4 their PSNR through the port's
decoder; config 5 the peak device memory of one encode
(torch.cuda.max_memory_allocated). Every row is stamped with the date and
the device (on the card: its name and power limit, as nvidia-smi prints
them). --streams DIR writes the config 3 and config 5 codestreams with the
pixels they were encoded from (the u8 samples linearized through the
encoder's own table, constants.SRGB_U8_TO_LINEAR) as .pfm files,
for tools/psnr_file.py.

Each mode merges its rows into --out (default: bench_configs_h100.json
beside this file). The JAX package's rows stay in tools/bench_configs.json.

The inputs are built as the JAX tool builds them. The u8 ones convert
photo8mp to u8 sRGB first and then cut or flip it, which gives the same
samples as converting the cut image (the conversion is elementwise) at an
eighth of the host work.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

from .psnr_file import psnr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.normpath(os.path.join(HERE, "..", ".."))
OUT = os.path.join(HERE, "bench_configs_h100.json")
DISTANCES = (0.5, 1.0, 2.0)
# Config 3 and config 5 at full size (tools/bench_configs.py:172-181, 201-205).
TILES, TILE, PANORAMA = 64, 1024, (8192, 7680)
# The JAX tool's reference rows: (key, golden stream, source image).
REF_CASES = (
    ("config1_512_d1.0", "gradient512.jxl", "gradient512"),
    ("config2_8mp_d1.0", "photo8mp.jxl", "photo8mp"),
    ("config4_8mp_d1.0", "photo8mp.jxl", "photo8mp"),
    ("sweep_512_d0.5", "gradient512_d0.5.jxl", "gradient512"),
    ("sweep_512_d1.0", "gradient512.jxl", "gradient512"),
    ("sweep_512_d2.0", "gradient512_d2.0.jxl", "gradient512"),
)
REF_SPEED = {
    "config2_8mp_d1.0": 21.9,
    "note": "only measurable config: single-core cjxl_tiny, 0.379 s user for the 8MP "
    "image (BASELINE.md round 1); the repo does not hold the binary, so configs 1/3/5 "
    "have no reference speed row. cjxl_tiny is single-threaded and its MP/s is roughly "
    "size-independent.",
}


def load(name):
    from ..io.pfm import read_pfm

    return read_pfm(os.path.join(REPO, "testdata", f"{name}.pfm"))


def tile_origins(h, w, n=TILES, size=TILE, seed=5):
    """(y, x) of the n tiles, drawn as the JAX tool draws them (y, then x,
    for each tile)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = rng.randint(0, h - size)
        x = rng.randint(0, w - size)
        out.append((y, x))
    return out


def tiles(img, n=TILES, size=TILE, seed=5):
    """[n, 3, size, size]: config 3's tiles of a [3, H, W] image."""
    return np.stack([img[:, y:y + size, x:x + size]
                     for y, x in tile_origins(img.shape[1], img.shape[2], n, size, seed)])


def panorama(img, h=PANORAMA[0], w=PANORAMA[1]):
    """Config 5's panorama of a [3, H, W] image: the image over its vertical
    flip, that beside its horizontal flip, that over its vertical flip, cut
    to [3, h, w] (8192x7680 from photo8mp)."""
    pan = np.concatenate([img, img[:, ::-1]], axis=1)
    pan = np.concatenate([pan, pan[:, :, ::-1]], axis=2)
    return np.ascontiguousarray(np.concatenate([pan, pan[:, ::-1]], axis=1)[:, :h, :w])


def _merge(rows, out):
    data = {}
    if os.path.exists(out):
        with open(out) as f:
            data = json.load(f)
    data.update(rows)
    with open(out, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(rows, indent=1, sort_keys=True))


def ref_rows(keys=None):
    """The reference rows (keys: a subset of REF_CASES' keys; default all,
    and the reference speed row): golden bytes and bpp, PSNR through the
    port's decoder, the decode's host time."""
    from ..decode import decode_jxl

    rows, decoded = {}, {}
    for key, golden, name in REF_CASES:
        if keys is not None and key not in keys:
            continue
        img = load(name)
        with open(os.path.join(REPO, "testdata", "golden", golden), "rb") as f:
            data = f.read()
        t = time.time()
        if golden not in decoded:
            decoded[golden] = decode_jxl(data)
        px = img.shape[1] * img.shape[2]
        rows["ref_" + key] = dict(
            bytes=len(data), bpp=round(8 * len(data) / px, 4),
            psnr=round(psnr(decoded[golden], img), 3), decode_s=round(time.time() - t, 1))
    if keys is None:
        rows["ref_speed_mps"] = REF_SPEED
    return rows


def _synced(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _single(img, dist, dev, repeats, decode):
    """(bytes, row) of one image's encode: encode_report's walls and, on the
    card, its two programs' device times; PSNR when decode."""
    from ..decode import decode_jxl
    from ..utils.profiling import encode_report

    data, rep = encode_report(img, dist, repeats=repeats, device=dev)
    wall = statistics.median(rep["times_s"])
    mp = img.shape[1] * img.shape[2] / 1e6
    row = dict(bytes=len(data), bpp=rep["bpp"], megapixels=round(mp, 3),
               wall_s=round(wall, 4), walls_s=rep["times_s"], mps=round(mp / wall, 3))
    for k in ("program_a_ms", "program_b_ms", "program_ms_are"):
        if k in rep:
            row[k] = rep[k]
    if decode:
        row["psnr"] = round(psnr(decode_jxl(data), img), 3)
    return data, row


def measure(device=None, small=None, photo=None, n_tiles=TILES, tile=TILE,
            pan=PANORAMA, repeats=3, streams=None):
    """Configs 1-5 -> (rows, codestreams). small / photo: config 1's image
    and the photograph of configs 2-5 (default gradient512 and photo8mp);
    n_tiles, tile and pan size configs 3 and 5 (a test runs them smaller).
    streams: a directory for the config 3 and 5 codestreams and their
    sources (see the module docstring)."""
    import torch

    from .. import constants as C
    from .. import encoder as TE
    from ..common import ImageDim
    from ..io.color import linear_to_srgb_u8
    from ..io.pfm import write_pfm
    from ..transfer import resolve_device
    from ..utils.profiling import card_name

    dev = resolve_device(device)
    small = load("gradient512") if small is None else small
    photo = load("photo8mp") if photo is None else photo
    prefix = "gpu" if dev.type == "cuda" else dev.type
    rows, out = {}, {}

    out["config1"], rows[f"{prefix}_config1_512_d1.0"] = _single(small, 1.0, dev, repeats,
                                                                 True)
    for dist in DISTANCES:
        data, row = _single(photo, dist, dev, repeats, True)
        out[f"config4_d{dist}"], rows[f"{prefix}_config4_8mp_d{dist}"] = data, row
        if dist == 1.0:
            rows[f"{prefix}_config2_8mp_d1.0"] = row

    photo8 = linear_to_srgb_u8(photo)
    batch = tiles(photo8, n_tiles, tile)
    dim = ImageDim(tile, tile)
    TE.encode_batch_device(batch, 1.0, device=dev)  # warm
    walls = []
    for _ in range(repeats):
        _synced(dev)
        t = time.perf_counter()
        outs = TE.encode_batch_device(batch, 1.0, device=dev)
        _synced(dev)
        walls.append(time.perf_counter() - t)
    wall, total = statistics.median(walls), sum(map(len, outs))
    mp = n_tiles * tile * tile / 1e6
    out["config3"] = outs
    rows[f"{prefix}_config3_batch{n_tiles}x{tile}"] = dict(
        total_bytes=total, bpp=round(8 * total / (mp * 1e6), 4), megapixels=round(mp, 3),
        groups=n_tiles * dim.num_groups, dc_groups=n_tiles * dim.num_dc_groups,
        wall_s=round(wall, 4), walls_s=[round(w, 4) for w in walls],
        aggregate_mps=round(mp / wall, 3))

    pan8 = panorama(photo8, *pan)
    dim = ImageDim(pan8.shape[2], pan8.shape[1])
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        TE.encode_image_device(pan8, 1.0, device=dev)
        peak = torch.cuda.max_memory_allocated(dev)
    data, row = _single(pan8, 1.0, dev, repeats, False)
    row.update(groups=dim.num_groups, dc_groups=dim.num_dc_groups,
               max_memory_allocated_bytes=peak)
    out["config5"], rows[f"{prefix}_config5_{pan8.shape[1]}x{pan8.shape[2]}"] = data, row

    stamp = dict(date=time.strftime("%Y-%m-%d"),
                 device=card_name(dev.index or 0) if dev.type == "cuda" else str(dev))
    for row in rows.values():
        row["measured"] = stamp
    if streams is not None:
        os.makedirs(streams, exist_ok=True)
        pairs = [(f"config3_tile{k:02d}", data, batch[k]) for k, data in enumerate(outs)]
        pairs.append(("config5", out["config5"], pan8))
        for name, data, u8 in pairs:
            with open(os.path.join(streams, f"{name}.jxl"), "wb") as f:
                f.write(data)
            write_pfm(os.path.join(streams, f"{name}.pfm"), C.SRGB_U8_TO_LINEAR[u8])
    return rows, out


def main(argv=None):
    p = argparse.ArgumentParser(prog="jxl_tiny_tpu_torch.tools.bench_configs")
    p.add_argument("--ref", action="store_true",
                   help="the reference rows from testdata/golden/ (host only)")
    p.add_argument("--out", default=OUT, help="JSON file the rows are merged into")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' runs the plain versions there")
    p.add_argument("--streams", default=None,
                   help="directory for config 3 and 5's codestreams and sources (.pfm)")
    args = p.parse_args(argv)
    if args.ref:
        rows = ref_rows()
    else:
        rows, _ = measure(args.device, streams=args.streams)
        if args.streams:
            print(f"PSNR of configs 3 and 5: python -m jxl_tiny_tpu_torch.tools.psnr_file "
                  f"{args.streams}/<name>.jxl {args.streams}/<name>.pfm ...", file=sys.stderr)
    _merge(rows, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
