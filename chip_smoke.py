#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jxl_tiny_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--trace-out DIR]

Phases (any failure exits non-zero at once):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every kernel in jxl_tiny_tpu_torch/csrc (nvcc, parallel;
              csrc/probe.cu also at the probe's two other flag sets)
              and the native host packer (cpp/pack.cc, g++), which must load:
              BitWriter.to_bytes may not fall back to numpy here
  3. kernels  feed each kernel the real tensors of the port's default path
              on testdata/photo8mp.pfm (3840x2160, 135 groups; real strategy
              maps and 16x8 / 8x16 coefficient sets) and hold its output
              against its plain torch version (exact; the quantizer and
              the tokenizer also on an all-DCT8 map; aq_field and
              quantize_cells also at their edges: one group, three, no
              colour modulation, pixels beyond the kernel's in-range
              division, all three strategies inside a group, values at the
              clamps); time kernel (quantize_cells on both maps), plain
              version, a one-call torch equivalent where one exists, and
              the bytes/operations bound; then time program A's stages one
              by one. compact_rows and copy_sections
              are held at every shape the encode launches them at (program
              A's tokens, program B's AC and DC word rows, the AC and DC
              sections); their one-call equivalent is zero_() + index_put_.
              estimate_partials also at one group, three, slope 1, scaled
              and infinite coefficients. bitpack_groups_var, which no
              encode path calls, gets program B's real AC tokens (also at an
              ow that cuts a run of tokens) and the DC layout's tokens at
              both ow, as int32 fields, and must also equal
              bitpack_groups_words where no section overflows
  4. encode   the 8 MP encode at the default configuration through the
              public entry point: every kernel of the path must have
              launched, and the bytes must equal the same encode through
              the plain versions; its warm walls and the two programs'
              device times from utils/profiling.encode_report, whose report
              is printed on one line; the same for the one-pass static tier;
              then bitpack_groups_var driven as program B's AC packer
              (its own launch count); then the fixed-8x8 configuration on
              small images, and photo256, gradient512, odd131x77 and tiny64
              at both configurations byte for byte against the JAX
              package's CPU streams (sha256), and as u8 sRGB against the
              port's CPU streams (U8_CPU_DIGESTS); photo8mp as u8 sRGB
              against its digest (PHOTO8MP_U8)
  4b. graphs  the compiled programs (ops/programs, the counterpart of
              jax.jit): the cache cleared, then photo8mp as float16 (default
              and static tier) and as u8 sRGB, each eager
              (ops/programs.eager()), then a first call (eager by rule),
              the call that captures and two replays: bytes equal to phase
              4's, each wrapper's launches equal to the eager run's and
              once a program, first calls, captures and replays counted;
              one more replay under torch.profiler, whose kernels counted
              by name must equal the wrappers' counts; the 16 small-image
              encodes as first calls, captures and replays against their
              digests; the depth-3 stream of four 8 MP images (one graph a
              program) and the batch of eight crops as replays against
              their eager encodes; six u8 crops of six sizes, eager and as
              first calls (nothing captured), captures and replays, each
              pass timed; eager against replay: the programs' device ms
              and host queueing (encode_report), the e2e float16 and u8
              walls, the device-resident A+B and its busy share; each key's
              first call ms, capture ms and pool bytes; the cache cleared
  5. multi-image
              program A and program B (both tiers) queued under
              torch.cuda.set_sync_debug_mode("error"): no host sync; four 8
              MP images (photo8mp, its flips, its 180-degree turn) through
              encode_images_device against their serial encodes (same
              bytes, input order, no retry), warm walls of both; eight
              1024x1024 crops through encode_batch_device, float and u8
              sRGB, default and static tier, against their single encodes
              and the plain versions' batch encode, each kernel launching
              once a program and every kernel call held against its plain
              version; the four 8 MP images as one 540-group batch
              (copy_sections past its 512 groups of shared-memory offsets),
              every kernel call held against its plain version and timed at
              the batch's shapes
  6. mesh     the multi-GPU path (jxl_tiny_tpu_torch/parallel/), ranks as
              spawned processes: NCCL with one rank a card over every card
              (photo8mp in both tiers and with the owner DC exchange, equal
              to the single encodes; both tiers queued with no host sync;
              walls against encode_image_device; each collective's device
              time and bytes; eight 1024x1024 crops through
              encode_batch_device(mesh=) against the one-card batch); then 2
              and 4 ranks sharing card 0 over gloo (both tiers and the owner
              exchange, equal bytes; at 4 ranks every kernel call of rank 0
              and of rank 3, whose 34 groups hold the padding group, held
              against its plain version and timed at its shard-local shape)
  7. verify   the verification side: photo8mp through the host-packed path
              (encode_image_host_packed: the full-context analysis on the
              card, codes and packing on the host), float32 and float16
              upload, every kernel call (aq_field, estimate_partials) held
              against its plain version, bytes equal to the plain versions'
              host-packed encode, the cap retry logged; gradient512 at cap
              1000 (analyses at 1000, then FULL_CAP; bytes equal to the
              uncapped call's); the device-packed
              and host-packed analyses of one float16 upload equal (maps,
              totals, token values); the numpy golden model's encode_image
              on this machine's host, compared group by group (at most a
              tenth of the groups may differ at float ties); the full (fast=False) route and make_analyze_fn on a
              1024x1024 crop, bytes equal to the fast route's; the port's
              decoder on photo256, gradient512 and odd131x77 through all
              three pipelines (PSNR above tests/test_roundtrip.py's GOLDEN
              bar, device and host pixels bit-identical) and on photo8mp's
              device and golden streams (PSNR within 0.1 dB); the host
              path's wall split into its stages
  8. debug    the checked build (ops/_build.CHECKED_FLAGS, csrc/check.cuh:
              every kernel access tested against its buffer's extent) of
              the six encode sources, nvcc in parallel, with each source's
              registers and spill bytes beside the normal build's (-Xptxas
              -v); every call the photo8mp encode makes of the six encode
              kernels (recorded: phase 3's shapes) and phase 3's
              bitpack_groups_var call through the checked build, equal to
              the normal build and the plain version with no fault, both
              builds timed call by call; one injected fault a kernel
              (tools/checked_kernels.inject: the launcher called with one
              output's extent one element short, a canary tail after it):
              reported with the kernel and a guard line of that buffer, the
              canary intact, the next normal launch still right;
              utils/debug.debug_mode (NaN checks after program A's float
              stages, the checked kernels) on photo256, gradient512,
              odd131x77 and photo8mp in the default and static tiers, on
              the kernels and with kernels=False (their plain versions on
              the card): bytes equal to the same encode outside debug mode,
              every kernel launched in the first and none in the second,
              walls of all three; the exactness probe (tools/probe_op_exactness) on the
              card, one line an op with each column's share of values off
              the float64 reference and max ulp, probe_elementwise at the
              port's flags bit-equal to its plain version for every op but
              cbrt, probe_dot_i8 equal to the int32 product; both kernels
              timed at the probe's shapes; then (tools/bench_probe's shapes)
              probe_dot_i8 against its plain version, torch._int_mm and
              numpy at the probe's pair, at [77,40] x [40,24] and at one
              zig-zag chunk of photo8mp, [414720,128] x [128,128] (one-hot
              and random full-range B), timed there; its SASS (the toolkit's
              cuobjdump) must hold IMMA tensor-core instructions;
              probe_elementwise against its plain version at [3,2160,3840]
              (every op but cbrt), at a start one element in and at n % 4
              != 0, div and cbrt timed there; with --trace-out DIR,
              the Chrome trace of encode_report(photo8mp) lands in DIR,
              gzipped. compute-sanitizer is not part of
              the run: it could not attach to the card it was tried on
              (PERF.md); `python -m jxl_tiny_tpu_torch.utils.debug` is the
              program to run under it where it can
  9. configs  the shapes of BASELINE.md's configs 3-5 (this module's tiles
              and panorama build the inputs): the 8192x7680 u8 panorama (960
              groups in 16 DC groups) through encode_image_device, and 64 u8
              tiles of 1024x1024 (1,024 groups) through encode_batch_device;
              each kernel once a program, every kernel call held against its
              plain version and timed at these shapes (one kernel's calls at
              a time), the bytes equal to the kernels=False encodes, each
              tile's bytes equal to its single encode; the panorama again
              inside debug_mode() (checked kernels), bytes equal and no
              fault; photo8mp at d = 0.5 and 2.0 equal to its kernels=False
              encodes; the counted runs are replays of captured programs
              (the references, kernels=False, run eagerly), and the captured
              programs are cleared after each part; the phase's duration
The line before the last is the kernels' JSON record (rows 1-8 with a
"checked" entry: the checked build's and the normal build's ms at phase
8's calls); the last line is the result JSON. Imports nothing of JAX or of
the JAX package.
"""
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Instructions csrc/strategy.cu issues a coefficient-channel value: ~22 in
# the arithmetic of a warp item's 12 values a lane, ~10 for its loads,
# butterfly and stores (cuobjdump -sass of the sm_90a build; see
# tools/bench_strategy_bitpack.py --sass).
STRATEGY_OPS_PER_VALUE = 32
DIST = 1.0
# Sizes and sha256 digests of the JAX package's encode_image_device(img,
# 1.0, upload_dtype=None) on the CPU (XLA:CPU, Pallas in interpret mode), at
# the default configuration and with EncoderConfig(optimize_block_sizes=
# False). The port's CPU path reproduces every one byte for byte, and
# tests/test_torch_encode.py ties each to a live JAX encode; the card must
# give the same bytes.
JAX_CPU_DIGESTS = {
    "default": {
        "photo256": (3426, "1d3aa9748f24055fe6aa1524973567a045ff705d45c90b4d69a93ac0be05d442"),
        "gradient512": (11680, "29dc2da822d6528147ca8488a60e8e1c9d92f4c965687de2f9d2fab0c12d3a41"),
        "odd131x77": (1061, "c8bdcd4e024107973d5ea129c348a7701a33654420d1f4c7a57c992ec0152a39"),
        "tiny64": (394, "2b81a6a8bb900176fc4fdf16b619b78b69ebe3dca90b48a45c26d15152a429af"),
    },
    "fixed 8x8": {
        "photo256": (3931, "15e0fd1b3196a1b2ac9e1806f19e4f6f62c313e482fae08413b75742ca801460"),
        "gradient512": (13484, "fa5ef170fc9f8dea09b1f380f41db1239e8dfcd31c60ef14730d052e77d8336c"),
        "odd131x77": (1165, "6cab02bb9daf47eb4e13ecc0263f741cf13cc034d9042a5d4b239364f0ac8bcf"),
        "tiny64": (444, "f2e33af05bc2e86e2296360930c0ec115bfe809e0fb03cf0ed7b225e4a908e96"),
    },
}
# The same images as 8-bit sRGB (io/color.linear_to_srgb_u8), linearized
# through constants.SRGB_U8_TO_LINEAR: the port's CPU streams, sizes and
# sha256 (tests/test_torch_u8_ingest.py ties each to a live CPU encode). Each
# equals the JAX package's u8 encode on the CPU but gradient512 at the
# default configuration (JAX 11,725 B): two AC values of one 16x8 transform
# round the other way at a near-tie of JAX's own inputs (-1.5000039).
U8_CPU_DIGESTS = {
    "default": {
        "photo256": (3442, "c4923b8a6fea340e8356fdd9ad772a77d088115e2fade27db189a3b67c2d6a22"),
        "gradient512": (11724, "ab14126de2d16ef25d99f6e399a6292c895a6e8e2201e86eb8bacb26a1a6e4e8"),
        "odd131x77": (1074, "ffec1d6fc8fab332d8cefdd02077f2b46afaa62dfea7be1f2ca446a266975197"),
        "tiny64": (648, "46c856ec810225b736a26a100b2cbba51066eccb7ca6b667124954f408b6e661"),
    },
    "fixed 8x8": {
        "photo256": (3875, "4c5ddd0304f1977d869e4b76ebb9028db8a28da2e5183310a29bda5fa6fe077e"),
        "gradient512": (13415, "67f614564f56daebccbdf681e8564c088867be14c924870146a07560662a5021"),
        "odd131x77": (1171, "dfde58dcc1ea248f4fcf80882cd95f22f37d5d521a08c526eddbc3377f4ca98c"),
        "tiny64": (437, "2a77efc39539d725446c7ec6c16ae8a88f9a3164d8c9f90d02c57a016a5a8817"),
    },
}
# photo8mp as 8-bit sRGB at the default configuration: the port's CPU
# stream (size, sha256), which the card reproduces, and what
# tools/device_diff.py found between the two devices.
PHOTO8MP_U8 = (384020, "c4b9c1b734fb6dae7a8e2a027d53009c6aed39b173bb0bb55ab64ee31225f3d2",
               "the CPU's stream; tools/device_diff.py: no decision differs, only the AQ "
               "tail's float32 log2 / exp2 (qf, 28% of its values)")
# The static tier may cost this much over the two-pass size on photographs
# (the bound of the JAX package's tests/test_config_tiers.py).
STATIC_OVERHEAD = 1.06
# Reference PSNR (dB) of the reference encoder's golden streams at d=1.0,
# pre-filter, through the verification decoder (GOLDEN of
# tests/test_roundtrip.py); every pipeline's encode must decode above it
# less 0.1 dB, the bar that test holds the JAX package's encodes to.
GOLDEN_PSNR = {"photo256": 39.92, "odd131x77": 40.68, "gradient512": 38.96}

# BASELINE.md's config 3 (64 tiles of 1024x1024 as one batch) and config 5
# (the 8192x7680 panorama of photo8mp's flips): phase 9's inputs, built as
# the JAX package's tools/bench_configs.py builds them (:172-181, 201-205).
TILES, TILE, PANORAMA = 64, 1024, (8192, 7680)


def load(name):
    """testdata/<name>.pfm: a [3, H, W] linear float32 image."""
    from jxl_tiny_tpu_torch.io.pfm import read_pfm

    return read_pfm(os.path.join(HERE, "testdata", f"{name}.pfm"))


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


def stream_images(img):
    """The image, its two flips and its 180-degree turn: the stream of
    phases 4b and 5."""
    return [img, np.ascontiguousarray(img[:, :, ::-1]), np.ascontiguousarray(img[:, ::-1, :]),
            np.ascontiguousarray(img[:, ::-1, ::-1])]


def eight_crops(img, side=1024):
    """Eight side x side crops: rows at 0 and side, columns at 0, side,
    2 side and the right edge (the batch of phases 4b and 5)."""
    w = img.shape[2]
    return [np.ascontiguousarray(img[:, y:y + side, x:x + side])
            for y in (0, side) for x in (0, side, 2 * side, w - side)]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def psnr(a, b):
    """PSNR (dB) of a decoded image, clipped to [0, 1], against the source."""
    mse = np.mean((np.clip(a, 0, 1).astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def bound(nbytes, nops):
    t_b = nbytes / MEM_BYTES_PER_S * 1e3
    t_o = nops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def compare(name, outs_k, outs_p, nan_ok=False):
    """Exact equality of kernel and plain outputs (tools/kernel_check.compare:
    bitwise for floats; with nan_ok a NaN equals any NaN, whatever its
    payload); exits on a mismatch."""
    from jxl_tiny_tpu_torch.tools import kernel_check as KC

    bad, err, nans = KC.compare(outs_k, outs_p, nan_ok)
    log(f"  {name}: mismatches {bad}, max_abs_err {err}"
        + (f", NaN in both at {nans} elements" if nan_ok else ""))
    if nan_ok and not nans:
        fail(f"{name}: expected NaNs in both outputs")
    if bad:
        fail(f"{name}: kernel disagrees with its plain version in {bad} elements")
    return err


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--trace-out", default=None,
                   help="directory for the gzipped torch.profiler trace of phase 8")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "jxl_tiny_tpu_torch")):
        fail("jxl_tiny_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, HERE)
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    log(card)

    from jxl_tiny_tpu_torch.ops import _build

    # -- 2. build ----------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from jxl_tiny_tpu_torch.ops import probe_kernels as PBK

    t0 = time.time()
    # Every source at the port's flags, and the probe's kernel at the two
    # other flag sets it compares, all nvcc processes at once.
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(_build.build_all)] + [
            pool.submit(_build.build_all, PBK.FLAG_SETS[fs], ("probe",))
            for fs in PBK.FLAG_SETS if fs != "port"]
        libs = builds[0].result()
        for b in builds[1:]:
            b.result()
    log(f"build: {len(libs)} libraries ({', '.join(sorted(libs))}) and csrc/probe.cu at "
        f"{len(builds) - 1} other flag sets in {time.time() - t0:.1f} s")
    from jxl_tiny_tpu_torch.cpp import build as native

    t0 = time.time()
    if native.native_packer() is None:
        fail("the native host packer did not load (no g++?): BitWriter.to_bytes "
             "would fall back to numpy")
    log(f"build: native host packer {native.library_path()} in {time.time() - t0:.1f} s")

    from jxl_tiny_tpu_torch import constants as C
    from jxl_tiny_tpu_torch.common import EncoderConfig, compute_distance_params
    from jxl_tiny_tpu_torch.encoder import encode_image_device
    from jxl_tiny_tpu_torch.entropy.entropy_write import (
        build_ac_device_code, build_dc_device_code,
    )
    from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
    from jxl_tiny_tpu_torch.ops import aq_kernel as AQ
    from jxl_tiny_tpu_torch.ops import dc_kernels as DK
    from jxl_tiny_tpu_torch.ops import pack_kernels as PK
    from jxl_tiny_tpu_torch.ops import pipeline as PL
    from jxl_tiny_tpu_torch.ops import quantize_kernel as QK
    from jxl_tiny_tpu_torch.ops import strategy_kernel as SK
    from jxl_tiny_tpu_torch.ops import tokenize_kernel as TK
    from jxl_tiny_tpu_torch.ops.dct import dct2d_8x8
    from jxl_tiny_tpu_torch.tables import numpy_tables, tables_from_numpy
    from jxl_tiny_tpu_torch.tools import bench_strategy_bitpack as BS
    from jxl_tiny_tpu_torch.tools import kernel_check as KC
    from jxl_tiny_tpu_torch.utils.profiling import busy_share, device_time, encode_report

    dev = torch.device("cuda")
    tables = tables_from_numpy(numpy_tables(), dev)
    cfg = EncoderConfig()
    cfg_8x8 = EncoderConfig(optimize_block_sizes=False)
    cfg_static = EncoderConfig(optimize_code=False)
    img8 = load("photo8mp")
    h, w = img8.shape[1:]
    mp = h * w / 1e6
    distp = compute_distance_params(DIST)
    rec = {}

    def record(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by,
               library_ms):
        rec[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")

    # -- 3. kernels at the main path's shapes --------------------------------
    log("kernels: photo8mp, the upstream tensors of the port's default path")
    up = torch.from_numpy(img8.astype(np.float16)).to(dev)
    groups = PL.extract_groups_device(up)
    g = groups.shape[0]
    xyb = PL.to_xyb(groups)

    # AQ field.
    consts, color = AQ.aq_constants(distp.distance)
    kv = torch.from_numpy(consts).to(dev)
    outs_k = AQ.aq_field(xyb, distp.distance)
    outs_p = AQ.aq_field_plain(xyb, consts, color)
    err = compare("aq_field", outs_k, outs_p)
    ms = device_time(lambda: AQ.aq_field(xyb, distp.distance), 20)
    pms = device_time(lambda: AQ.aq_field_plain(xyb, consts, color), 3, 1)
    npx = g * 256 * 256
    record("aq_field", "jxl_tiny_tpu_torch/csrc/aq.cu",
           "jxl_tiny_tpu/ops/aq_kernel.py:89", err, ms, pms,
           *bound(xyb.numel() * 4 + 3 * g * 1024 * 4 + kv.numel() * 4, npx * 150),
           None)

    # aq_field at its edges: one group, three, the colour modulation off
    # (distance 5), and pixels beyond the range of the kernel's in-range
    # division and square root (those rows take the compiler's own).
    big, large = xyb[:2].clone(), xyb[:2].clone()
    big[:, :, 60:131, 30:97] *= 2.0e5
    large[:, :, 60:131, 30:97] *= 2.0e4
    for label, t, d in (("1 group", xyb[:1], DIST), ("3 groups", xyb[5:8], DIST),
                        ("2 groups, d=5, no colour modulation", xyb[:2], 5.0),
                        ("2 groups, pixels beyond the fast range", big, DIST),
                        ("2 groups, large pixels inside the fast range", large, DIST)):
        c_e, color_e = AQ.aq_constants(d)
        if color_e != (d == DIST):
            fail(f"aq_field ({label}): unexpected colour flag {color_e}")
        compare(f"aq_field ({label})", AQ.aq_field(t.contiguous(), d),
                AQ.aq_field_plain(t.contiguous(), c_e, color_e))
    del big, large

    # Strategy estimates (kernel E), on the real DCTs and AQ maps.
    qf, masking, raw_qf = AQ.adaptive_quant_field(xyb, distp.distance, distp.inv_scale)
    blocks8 = xyb.reshape(g, 3, 32, 8, 32, 8).permute(0, 1, 2, 4, 3, 5)
    coef8 = dct2d_8x8(blocks8, tables.dct8)
    yb = torch.tensor([-(-min(256, h - gy * 256) // 8) for gy in range(-(-h // 256))
                       for _ in range(-(-w // 256))], device=dev)
    xb = torch.tensor([-(-min(256, w - gx * 256) // 8) for _ in range(-(-h // 256))
                       for gx in range(-(-w // 256))], device=dev)
    ar = torch.arange(32, device=dev)
    valid = (ar[None, :, None] < yb[:, None, None]) & (ar[None, None, :] < xb[:, None, None])
    ytox, ytob = PL.compute_cmap(coef8, valid, tables)
    e_args = PL.strategy_inputs(coef8, qf, masking, ytox, ytob, tables)
    slope = min(1.0, distp.distance / 3.0)
    outs_k = SK.estimate_partials(*e_args, slope)
    outs_p = SK.estimate_partials_plain(*e_args, slope)
    err = compare("estimate_partials", outs_k, outs_p)
    ms = device_time(lambda: SK.estimate_partials(*e_args, slope), 20)
    pms = device_time(lambda: SK.estimate_partials_plain(*e_args, slope), 3, 1)
    e_bytes = sum(a.numel() * 4 for a in e_args) + sum(o.numel() * 4 for o in outs_k)
    n_coef = sum(a.numel() for a in e_args[:3])
    # Operations: what the kernel's SASS issues a coefficient-channel value
    # (none of them fused), at the float32 rate of operations that are not
    # FMAs (the 67 TFLOP/s peak counts an FMA as two).
    t_ops = n_coef * STRATEGY_OPS_PER_VALUE / (F32_OPS_PER_S / 2) * 1e3
    t_bytes, _ = bound(e_bytes, 0)
    log(f"  estimate_partials bound: bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms "
        f"({STRATEGY_OPS_PER_VALUE} a value, {n_coef} values) [{card}]")
    record("estimate_partials", "jxl_tiny_tpu_torch/csrc/strategy.cu",
           "jxl_tiny_tpu/ops/strategy_kernel.py:147", err, ms, pms,
           *((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), None)
    del outs_p

    # estimate_partials at its edges: one group, three, slope 1 (distance
    # >= 3), scaled values far above the fast square root's usual operands
    # (still in its range, which holds every finite value), and an infinite
    # coefficient, whose NaNs send its warp items to the sqrtf fallback
    # (NaN compared as NaN: payloads may differ).
    def e_edge(label, n, gain=1.0, poison=False, sl=slope, nan_ok=False):
        args = [a[:n].contiguous() for a in e_args[:12]] + list(e_args[12:])
        if gain != 1.0 or poison:
            args[:3] = [a * gain for a in args[:3]]
        if poison:
            args[0][0, 1, 5, 7, 9] = float("inf")
            args[2][n - 1, 0, 30, 3, 100] = float("inf")
        compare(f"estimate_partials ({label})", SK.estimate_partials(*args, sl),
                SK.estimate_partials_plain(*args, sl), nan_ok=nan_ok)

    e_edge("1 group", 1)
    e_edge("3 groups", 3)
    e_edge("2 groups, slope 1.0", 2, sl=1.0)
    e_edge("2 groups, coefficients x 1e30", 2, gain=1.0e30)
    e_edge("2 groups, an infinite coefficient in two cells", 2, poison=True, nan_ok=True)

    # The decisions those estimates lead to: the real strategy maps that
    # the quantizer, the tokenizer and the compaction are held against.
    strategy, is_first, coef_v, coef_h = PL.compute_ac_strategy(
        coef8, qf, masking, ytox, ytob, distp.distance, yb, xb, tables)
    raw_qf8 = raw_qf  # the field of an all-DCT8 map, before the adjustment
    raw_qf = PL.adjust_quant_field(strategy, is_first, raw_qf)
    n_valid = int(valid.sum())
    share_v = int(((strategy == 1) & valid).sum()) / n_valid
    share_h = int(((strategy == 2) & valid).sum()) / n_valid
    log(f"  strategy photo8mp: {100 * share_v:.2f}% of valid cells in 16x8, "
        f"{100 * share_h:.2f}% in 8x16, {100 * (1 - share_v - share_h):.2f}% in 8x8")
    if not (share_v > 0.0 and share_h > 0.0):
        fail("photo8mp: the search chose only one kind of transform")

    # Quantize. On this image the search may leave no cell a DCT8, so the
    # kernel is also held against its plain version on an all-DCT8 map
    # over the same coefficients (the fixed-8x8 path's tensors).
    fac_x, fac_b = PL.cfl_factors(ytox, ytob)
    c8 = coef8.reshape(g, 3, 32, 32, 64).contiguous()
    all8 = torch.zeros_like(strategy)
    q8_args = (c8, coef_v, coef_h, all8, raw_qf8.contiguous(), fac_x, fac_b,
               tables, distp.scale, distp.scale_dc, distp.x_qm_mul)
    err8 = compare("quantize_cells (all DCT8)", QK.quantize_cells(*q8_args),
                   QK.quantize_cells_plain(*q8_args))
    q_args = (c8, coef_v, coef_h, strategy, raw_qf.contiguous(), fac_x, fac_b,
              tables, distp.scale, distp.scale_dc, distp.x_qm_mul)
    outs_k = QK.quantize_cells(*q_args)
    outs_p = QK.quantize_cells_plain(*q_args)
    err = max(err8, compare("quantize_cells", outs_k, outs_p))
    ms = device_time(lambda: QK.quantize_cells(*q_args), 20)
    ms8 = device_time(lambda: QK.quantize_cells(*q8_args), 20)
    log(f"  quantize_cells on both maps: real strategy map {ms:.4f} ms, all-DCT8 "
        f"map {ms8:.4f} ms [{card}]")
    pms = device_time(lambda: QK.quantize_cells_plain(*q_args), 3, 1)

    # quantize_cells at its edges: one group; all three strategies inside
    # each group, cell by cell (pairs that disagree); values at the clamps.
    def q_edge(label, n, strat=None, gain=1.0):
        coefs = [a[:n] * gain for a in q_args[:3]]
        maps = [a[:n].contiguous() for a in q_args[3:7]]
        if strat is not None:
            maps[0] = strat
        args = (*coefs, *maps, *q_args[7:])
        outs = QK.quantize_cells(*args)
        compare(f"quantize_cells ({label})", outs, QK.quantize_cells_plain(*args))
        return outs

    q_edge("1 group", 1)
    mixed = torch.randint(0, 3, (2, 32, 32), generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32).to(dev)
    if any(int((mixed[i] == k).sum()) == 0 for i in range(2) for k in range(3)):
        fail("quantize_cells: the mixed map lacks a strategy in a group")
    q_edge("2 groups, all three strategies in each", 2, strat=mixed)
    clamped = q_edge("2 groups, coefficients x 1e6", 2, gain=1.0e6)
    top = int(clamped[0].abs().max()), int(clamped[2].abs().max())
    if top != (32767, 16383):
        fail(f"quantize_cells: the scaled coefficients did not reach the clamps: {top}")
    del clamped, mixed
    cells = g * 1024
    # Each cell needs its strategy's 3 x 64 coefficients (from one of the
    # three sets) + per-cell maps; ordered + nz/lastnz/qdc go out.
    q_bytes = (c8.numel() * 4 + 4 * cells * 4
               + cells * 384 * 4 + cells * 3 * 4 * 4)
    record("quantize_cells", "jxl_tiny_tpu_torch/csrc/quantize.cu",
           "jxl_tiny_tpu/ops/quantize_kernel.py:40", err, ms, pms,
           *bound(q_bytes, cells * 384 * 25), None)

    # Tokenize (covered = 1 and 2 rows, from the real maps), and before
    # that the rows of the all-DCT8 map.
    def em(a):
        return a[:, [1, 0, 2]].permute(0, 2, 3, 1)

    def token_rows(strat, is_f, rqf):
        m = PL.encode_middle(coef8, coef_v, coef_h, strat, is_f, rqf, ytox, ytob,
                             distp.scale, distp.scale_dc, distp.x_qm_mul, tables,
                             kernels=True)
        shp = m["nzeros_total"].shape
        cov_b = m["covered"][:, None].expand(shp)
        first_b = (is_f & valid)[:, None].expand(shp)
        meta = TK.pack_row_meta(em(cov_b).int(), em(m["nzeros_total"]).int(),
                                em(m["block_ctx"]).int(), em(m["nzero_ctx"]).int(),
                                em(m["prev_init"]).int(), em(first_b)).reshape(-1).contiguous()
        return m, cov_b, first_b, m["ordered"].reshape(-1, 128), meta

    _, _, _, x, meta = token_rows(all8, torch.ones_like(is_first), raw_qf8)
    err8 = compare("tokenize_rows (all DCT8)", [TK.tokenize_rows(x, meta, tables)],
                   [TK.tokenize_rows_plain(x, meta, tables.freq_tab, tables.nnz_thresh0)])
    m, cov_b, first_b, x, meta = token_rows(strategy, is_first, raw_qf)
    tok_k = TK.tokenize_rows(x, meta, tables)
    tok_p = TK.tokenize_rows_plain(x, meta, tables.freq_tab, tables.nnz_thresh0)
    err = max(err8, compare("tokenize_rows", [tok_k], [tok_p]))
    ms = device_time(lambda: TK.tokenize_rows(x, meta, tables), 20)
    pms = device_time(lambda: TK.tokenize_rows_plain(x, meta, tables.freq_tab,
                                                     tables.nnz_thresh0), 3, 1)
    n = x.shape[0]
    record("tokenize_rows", "jxl_tiny_tpu_torch/csrc/tokenize.cu",
           "jxl_tiny_tpu/ops/tokenize_kernel.py:108", err, ms, pms,
           *bound(n * 128 * 4 * 2 + n * 4, n * 128 * 30), None)

    # Row compaction and section copy, at every shape the encode launches
    # them at. library_ms is the one-call torch equivalent of the whole
    # function: zero_() + index_put_ on a preallocated buffer, with the
    # indices precomputed (index_put_ alone, which leaves the zero fill out,
    # is logged beside it).
    def library_times(buf, idx, vals, want, what, reps):
        if not torch.equal(buf.zero_().index_put_(idx, vals), want):
            fail(f"{what}: the zero_ + index_put_ yardstick computes something else")
        pair = device_time(lambda: buf.zero_().index_put_(idx, vals), reps)
        alone = device_time(lambda: buf.index_put_(idx, vals), reps)
        return pair, alone

    def hold_compact_rows(label, rows_tok, cnt, cap):
        """Kernel against plain version (exits on any mismatch) and yardstick
        on one call's tensors; returns the stream and the record's numbers."""
        ng = rows_tok.shape[0]
        start = torch.cumsum(cnt, 1, dtype=torch.int64) - cnt
        s_k = PK.compact_rows(rows_tok, cnt, start, cap)
        s_p = PK.compact_rows_plain(rows_tok, cnt, start, cap)
        err = compare(f"compact_rows ({label})", [s_k], [s_p])
        lane = torch.arange(128, device=dev)
        pos = start[..., None] + lane
        msk = (lane < cnt[..., None]) & (pos < cap)
        gi = torch.arange(ng, device=dev)[:, None, None].expand_as(pos)
        idx, vals = (gi[msk], pos[msk]), rows_tok[msk]
        lms, lms_alone = library_times(torch.empty_like(s_k), idx, vals, s_k,
                                       f"compact_rows ({label})", 20)
        ms = device_time(lambda: PK.compact_rows(rows_tok, cnt, start, cap), 20)
        pms = device_time(lambda: PK.compact_rows_plain(rows_tok, cnt, start, cap), 3, 1)
        nplaced = int(vals.numel())
        b_ms, b_by = bound(cnt.numel() * 12 + nplaced * 4 + s_k.numel() * 4, nplaced * 4)
        log(f"  compact_rows ({label}): rows {list(rows_tok.shape)} cap {cap}, "
            f"{nplaced} words placed, {int((cnt == 0).sum())} empty rows: kernel "
            f"{ms:.4f} ms, plain {pms:.4f} ms, zero_ + index_put_ {lms:.4f} ms "
            f"(index_put_ alone {lms_alone:.4f} ms), bound {b_ms:.4f} ms ({b_by}) "
            f"[{card}]")
        return s_k, (err, ms, pms, b_ms, b_by, lms)

    def hold_copy_sections(label, packed, bits, wcap):
        ng, ow_ = packed.shape
        nblk = (bits + 4095) // 4096
        offs = torch.cumsum(nblk * 128, 0) - nblk * 128
        b_k = PK.copy_sections(packed, nblk, offs, wcap)
        b_p = PK.copy_sections_plain(packed, nblk, offs, wcap)
        err = compare(f"copy_sections ({label})", [b_k], [b_p])
        wi = torch.arange(ow_, device=dev)[None, :]
        dst = offs[:, None] + wi
        cm = (wi < nblk[:, None] * 128) & (dst < wcap)
        dsel, psel = dst[cm], packed[cm]
        lms, lms_alone = library_times(torch.empty_like(b_k), (dsel,), psel, b_k,
                                       f"copy_sections ({label})", 50)
        ms = device_time(lambda: PK.copy_sections(packed, nblk, offs, wcap), 50)
        pms = device_time(lambda: PK.copy_sections_plain(packed, nblk, offs, wcap), 5, 1)
        ncopy = int(psel.numel())
        b_ms, b_by = bound(ng * 16 + ncopy * 4 + wcap * 4, 0)
        log(f"  copy_sections ({label}): packed {list(packed.shape)} wcap {wcap}, "
            f"{ncopy} words copied: kernel {ms:.4f} ms, plain {pms:.4f} ms, zero_ + "
            f"index_put_ {lms:.4f} ms (index_put_ alone {lms_alone:.4f} ms), bound "
            f"{b_ms:.4f} ms ({b_by}) [{card}]")
        return err, ms, pms, b_ms, b_by, lms

    def hold_var(label, fields, ow_, words):
        """bitpack_groups_var on int32 fields against its plain version and,
        unless a section overflows ow_ (words None), against the encode's
        packer's words; returns (max_abs_err, words)."""
        w_k = PK.bitpack_groups_var(*fields, ow_)
        err = compare(f"bitpack_groups_var ({label})", [w_k],
                      [PK.bitpack_groups_var_plain(*fields, ow_)])
        if words is not None and not torch.equal(w_k, words):
            fail(f"bitpack_groups_var ({label}): words differ from bitpack_groups_words")
        return err, w_k

    def var_bound(nbits, ow_):
        """The bytes bitpack_groups_var must move (tools/
        bench_strategy_bitpack.var_needed_bytes); ~6 integer operations a
        token."""
        nbytes = BS.var_needed_bytes(nbits, ow_)
        return bound(nbytes, (nbytes - nbits.shape[0] * ow_ * 4) // 8 * 6)

    def sections_wcap(ng, ow_):  # the encoder's buffer size rule
        return min(1 << int(ng * ow_).bit_length(), 2 * 1024 * 1024)

    # (a) Program A's token stream: the record's shape.
    count_em = torch.where(em(first_b), 1 + torch.clamp_min(
        em(m["lastnz"]) - em(cov_b) + 1, 0), 0).to(torch.int32)
    rows_tok = tok_k.reshape(g, -1, 128)
    cnt = count_em.reshape(g, -1).contiguous()
    totals = cnt.sum(1, dtype=torch.int64)
    cap = next(c for c in (32768, 65536, 131072, 262144) if int(totals.max()) <= c)
    s_k, nums = hold_compact_rows("program A tokens", rows_tok, cnt, cap)
    record("compact_rows", "jxl_tiny_tpu_torch/csrc/compact.cu",
           "jxl_tiny_tpu/ops/pack_kernels.py:144", *nums)

    # (b) Program B's AC word rows and AC sections (first code pass).
    stream = s_k[:, :cap].contiguous()
    hist = PK.hist_base64(stream, totals).cpu().numpy()[0]
    _, d_table = build_ac_device_code(hist, PK.ac_base64_map())
    d_table = torch.from_numpy(d_table).to(dev)
    data, nbits = PK.token_data_bits(stream, totals, d_table)
    ends = torch.cumsum(nbits, 1)
    ow = 8192
    need = int((ends[:, -1].max() + 31) // 32)
    while need > PK.var_safe_words(ow):
        ow = {8192: 32768, 32768: 131072}[ow]
    w_rows, w_cnt, _ = PK.word_rows(data, nbits, ends - nbits)
    hold_compact_rows("program B AC words", w_rows, w_cnt, ow)
    packed = PK.bitpack_groups_words(data, nbits, ends - nbits, ow)
    nums = hold_copy_sections("AC sections", packed, ends[:, -1], sections_wcap(g, ow))
    record("copy_sections", "jxl_tiny_tpu_torch/csrc/compact.cu",
           "jxl_tiny_tpu/ops/pack_kernels.py:880", *nums)

    # (c) Program B's DC word rows and DC sections, at both sizes the 8 MP
    # encode dispatches them with (the first one overflows and is retried).
    layout, dchist = PL.dc_layout_from_maps(
        m["quant_dc"], raw_qf, strategy, is_first, ytox, ytob, ysize=h, xsize=w,
        tables=tables)
    _, d_table_dc = build_dc_device_code(dchist.cpu().numpy()[0, : C.NUM_DC_CONTEXTS])
    dc_data, dc_nbits = DK.dc_token_data_bits(layout, torch.from_numpy(d_table_dc).to(dev))
    dc_ends = torch.cumsum(dc_nbits, 1)
    dc_pos = dc_ends - dc_nbits
    d_rows, d_cnt, _ = PK.word_rows(dc_data, dc_nbits, dc_pos, prefix_valid=False)
    gd = layout.shape[0]
    for ow_dc in (8192, 32768):
        hold_compact_rows(f"program B DC words, ow {ow_dc}", d_rows, d_cnt, ow_dc)
        packed_dc = PK.bitpack_groups_words(dc_data, dc_nbits, dc_pos, ow_dc,
                                            prefix_valid=False)
        hold_copy_sections(f"DC sections, ow {ow_dc}", packed_dc, dc_ends[:, -1],
                           sections_wcap(gd, ow_dc))
        # The token bit packer on the DC layout's tokens (zero widths
        # interleave), which no encode path calls.
        dc32 = tuple(t.to(torch.int32) for t in (dc_data, dc_nbits, dc_pos))
        over = int(dc_ends[:, -1].max()) > 32 * ow_dc
        hold_var(f"DC tokens, ow {ow_dc}{' (sections overflow)' if over else ''}", dc32,
                 ow_dc, None if over else packed_dc)
        dms = device_time(lambda: PK.bitpack_groups_var(*dc32, ow_dc), 20)
        log(f"  bitpack_groups_var (DC tokens {list(dc_data.shape)}, ow {ow_dc}): kernel "
            f"{dms:.4f} ms, bound {var_bound(dc32[1], ow_dc)[0]:.4f} ms [{card}]")
    del (layout, dc_data, dc_nbits, dc_ends, dc_pos, d_rows, d_cnt, packed_dc,
         w_rows, w_cnt, dc32)

    # Program A stage by stage (ops/pipeline.analyze_batch_packed's calls in
    # order, on this image's tensors; device time by CUDA events, 3 calls
    # each): where its time goes outside the five kernels.
    sc3 = (distp.scale, distp.scale_dc, distp.x_qm_mul)
    stage_fns = (
        ("extract_groups", lambda: PL.extract_groups_device(up)),
        ("to_xyb", lambda: PL.to_xyb(groups.to(torch.float32))),
        ("adaptive_quant_field (aq_field + log2/exp2 tail)",
         lambda: AQ.adaptive_quant_field(xyb, distp.distance, distp.inv_scale)),
        ("dct2d_8x8", lambda: dct2d_8x8(
            xyb.reshape(g, 3, 32, 8, 32, 8).permute(0, 1, 2, 4, 3, 5), tables.dct8)),
        ("compute_cmap", lambda: PL.compute_cmap(coef8, valid, tables)),
        ("compute_ac_strategy (16x8 / 8x16 DCTs + estimate_partials + decisions)",
         lambda: PL.compute_ac_strategy(coef8, qf, masking, ytox, ytob,
                                        distp.distance, yb, xb, tables)),
        ("adjust_quant_field", lambda: PL.adjust_quant_field(strategy, is_first, raw_qf8)),
        ("encode_middle (quantize_cells + context maps)",
         lambda: PL.encode_middle(coef8, coef_v, coef_h, strategy, is_first, raw_qf,
                                  ytox, ytob, *sc3, tables, kernels=True)),
        ("tokenize_cells (row meta + tokenize_rows)",
         lambda: TK.tokenize_cells(
             m["ordered"], em(cov_b), em(m["nzeros_total"]), em(m["block_ctx"]),
             em(m["nzero_ctx"]), em(m["prev_init"]), em(first_b), tables, True)),
        ("token counts + compact_stream (compact_rows)",
         lambda: PK.compact_stream(
             rows_tok, torch.where(em(first_b), 1 + torch.clamp_min(
                 em(m["lastnz"]) - em(cov_b) + 1, 0), 0).to(torch.int32).reshape(g, -1),
             cap, True)),
        ("hist_base64", lambda: PK.hist_base64(stream, torch.clamp_max(totals, cap))),
        ("dc_layout_from_maps (+ dc_hist)",
         lambda: PL.dc_layout_from_maps(m["quant_dc"], raw_qf, strategy, is_first,
                                        ytox, ytob, ysize=h, xsize=w, tables=tables)),
        # What the layout's five geometry vectors cost when they are copied
        # to the card on every call (the form before the sync repair).
        ("five geometry copies, per call (torch.tensor(..., device=))",
         lambda: [torch.tensor(v, dtype=torch.int64, device=dev)
                  for v in DK.dc_group_geometry(h, w).values()]),
    )
    stage_ms = {name: device_time(fn, 3, 1) for name, fn in stage_fns}
    log(f"program A stages photo8mp (CUDA events, ms): "
        f"{json.dumps({k: round(v, 4) for k, v in stage_ms.items()})}; sum "
        f"{sum(stage_ms.values()):.3f} ms [{card}]")
    # The u8 sRGB ingest: the table gather against the float32 formula it
    # replaced (six elementwise kernels), on photo8mp as u8; the bound reads
    # 1 B and writes 4 B a pixel of the padded groups.
    up8 = torch.from_numpy(linear_to_srgb_u8(img8)).to(dev)

    def formula():
        x = up8.to(torch.float32) * float(np.float32(1.0 / 255.0))
        lin = torch.exp(2.4 * torch.log(torch.clamp_min(
            (x + float(np.float32(0.055))) * float(np.float32(1.0 / 1.055)), 1e-7)))
        return torch.where(x <= float(np.float32(0.04045)),
                           x * float(np.float32(1.0 / 12.92)), lin)

    gather_ms = device_time(lambda: PL.extract_groups_device(up8), 3, 1)
    formula_ms = device_time(formula, 3, 1)
    ingest_bound = bound(up8.numel() + 4 * groups.numel(), 0)[0]
    log(f"u8 ingest photo8mp (CUDA events, ms): extract_groups_device (table gather + "
        f"tiling) {gather_ms:.4f}; the float32 formula alone {formula_ms:.4f}; bound "
        f"{ingest_bound:.4f} (bytes) [{card}]")
    del up8
    # Where dc_layout_from_maps' device time goes, kernel by kernel.
    prof = busy_share(dict(stage_fns)["dc_layout_from_maps (+ dc_hist)"])
    log("dc_layout_from_maps under torch.profiler: " + (
        "no device time recorded" if prof is None else
        f"wall {prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms; top kernels "
        f"(name, ms, calls) {prof['top']}") + f" [{card}]")

    # Token bit packer on the same AC tokens (off every encode path), as
    # int32 fields (converted once, outside the timed launches); then at an
    # ow that cuts a thread's run of tokens in two.
    ac32 = tuple(t.to(torch.int32) for t in (data, nbits, ends - nbits))
    err, w_k = hold_var("AC tokens", ac32, ow, packed)
    ms = device_time(lambda: PK.bitpack_groups_var(*ac32, ow), 20)
    pms = device_time(lambda: PK.bitpack_groups_var_plain(*ac32, ow), 3, 1)
    wms = device_time(lambda: PK.bitpack_groups_words(data, nbits, ends - nbits, ow), 3, 1)
    log(f"  bitpack_groups_words on the same tokens (the encode's packer: "
        f"torch passes + compact_rows): {wms:.4f} ms [{card}]")
    p0 = ac32[2][0]
    cut = next((int(p0[t + 4]) // 32 for t in range(1024, int(totals[0]) - 8, 8)
                if int(p0[t]) < 32 * (int(p0[t + 4]) // 32) < int(p0[t + 8])), None)
    if cut is None:
        fail("bitpack_groups_var: found no ow that cuts a run of group 0")
    err = max(err, hold_var(f"AC tokens, ow {cut} inside a run of group 0", ac32, cut,
                            packed[:, :cut].contiguous())[0])
    record("bitpack_groups_var", "jxl_tiny_tpu_torch/csrc/bitpack.cu",
           "jxl_tiny_tpu/ops/pack_kernels.py:735", err, ms, pms,
           *var_bound(ac32[1], ow), None)
    ac_stream, ac_totals, ac_table = stream, totals, d_table
    var_call = (*ac32, ow)  # phase 8 holds the checked build on the same call
    del (groups, xyb, coef8, c8, coef_v, coef_h, m, x, tok_k, tok_p, rows_tok,
         s_k, outs_k, outs_p, data, nbits, e_args, w_k, ac32, packed)
    torch.cuda.empty_cache()

    # -- 4. the 8 MP encode through the public entry point ------------------
    wrappers, _ = KC.on_path_kernels()

    off_path = (PK.bitpack_groups_var, PBK.probe_elementwise, PBK.probe_dot_i8)

    def reset_counts():
        for wr in (*wrappers.values(), *off_path):
            wr.launches = 0

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    data_k = encode_image_device(img8, DIST, config=cfg)
    t_first = time.time() - t0
    for name, wr in wrappers.items():
        rec[name]["launches"] = wr.launches
    log(f"encode photo8mp (default configuration): {len(data_k)} bytes, first "
        f"call {t_first:.3f} s; launches "
        f"{json.dumps({k: rec[k]['launches'] for k in wrappers})}")
    for name in wrappers:
        if not rec[name]["launches"]:
            fail(f"{name}: no launch on the main path")
    if any(wr.launches for wr in off_path):
        fail("a kernel off the encode path (bitpack_groups_var, the probe's) launched on it")

    # Warm walls and the two programs' device times: utils/profiling's
    # encode_report (a warm-up encode, then three timed ones).
    d, report = encode_report(img8, DIST, repeats=3, config=cfg)
    if d != data_k:
        fail("photo8mp: encode_report's encodes differ from the first")
    walls = report["times_s"]
    wall = statistics.median(walls)

    from jxl_tiny_tpu_torch.encoder import DeviceEncodeJob

    def synced_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # Where the wall time goes: the job's stages on the host clock, each
    # ending in a synchronize.
    up16, t_conv = synced_ms(lambda: img8.astype(np.float16))
    _, t_h2d = synced_ms(lambda: torch.from_numpy(up16).to(dev))
    job, t_init = synced_ms(lambda: DeviceEncodeJob([img8], DIST, config=cfg))
    _, t_pack = synced_ms(job.pack)
    _, t_fetch = synced_ms(job._fetch_sections)
    data_s, t_asm = synced_ms(job.result)
    if data_s != [data_k]:
        fail("photo8mp: staged job differs from encode_image_device")
    log(f"encode photo8mp ({w}x{h}, {mp:.2f} MP, d={DIST}, default configuration): "
        f"{len(data_k)} bytes, warm wall median of 3 {wall * 1e3:.1f} ms "
        f"({walls}), {mp / wall:.2f} MP/s; program A {report['program_a_ms']:.3f} ms, "
        f"program B {report['program_b_ms']:.3f} ms ({report['program_ms_are']}, CUDA "
        f"events; host time to queue a call: A {report['program_a_queue_ms']:.3f} ms, B "
        f"{report['program_b_queue_ms']:.3f} ms) [{card}]")
    log("encode_report photo8mp " + json.dumps(report))
    log(f"stages photo8mp (host clock, synced): f32->f16 {t_conv:.1f} ms, "
        f"f16 upload {t_h2d:.1f} ms; job init (conversion + upload + tables + "
        f"program A) {t_init:.1f} ms; pack (totals/hists read, entropy codes, "
        f"program B) {t_pack:.1f} ms; fetch (section sizes, capacity retries, "
        f"words read) {t_fetch:.1f} ms; assembly {t_asm:.1f} ms; final "
        f"cap {job.cap} ow {job.plan.ow} ow_dc {job.plan.ow_dc} [{card}]")

    data_p = encode_image_device(img8, DIST, config=cfg, kernels=False)
    if data_p != data_k:
        fail(f"photo8mp: kernel encode ({len(data_k)} B) differs from the plain "
             f"versions' encode ({len(data_p)} B)")
    log("encode photo8mp: bytes equal to the plain-version encode on the card")

    # The one-pass static tier: the same kernels in one program.
    reset_counts()
    job_s, t_static = synced_ms(lambda: DeviceEncodeJob([img8], DIST, config=cfg_static))
    (data_st,), t_static_rest = synced_ms(job_s.result)
    static_launches = {k: wr.launches for k, wr in wrappers.items()}
    if not all(static_launches.values()):
        fail(f"static tier: a kernel did not launch: {static_launches}")
    picks = job_s._small_sync()[-2:]
    over = len(data_st) / len(data_k)
    log(f"encode photo8mp (one-pass static codes): {len(data_st)} bytes "
        f"({100 * (over - 1):+.2f}% of the two-pass size), candidate picks AC "
        f"{int(picks[0])} DC {int(picks[1])}; job init {t_static:.1f} ms, pack + "
        f"fetch + assembly {t_static_rest:.1f} ms (host clock, synced); launches "
        f"{json.dumps(static_launches)}; final cap {job_s.cap} ow {job_s.plan.ow} "
        f"ow_dc {job_s.plan.ow_dc} [{card}]")
    if over >= STATIC_OVERHEAD:
        fail(f"static tier: {len(data_st)} B is not within 6% of {len(data_k)} B")
    if encode_image_device(img8, DIST, config=cfg_static, kernels=False) != data_st:
        fail("photo8mp: static-tier kernel encode differs from the plain versions' encode")
    log("encode photo8mp (static): bytes equal to the plain-version encode on the card")

    # bitpack_groups_var driven as program B's AC packer on the real stream.
    reset_counts()
    v_data, v_nbits = PK.token_data_bits(ac_stream, ac_totals, ac_table)
    v_ends = torch.cumsum(v_nbits, 1)
    v32 = tuple(t.to(torch.int32) for t in (v_data, v_nbits, v_ends - v_nbits))
    v_words = PK.bitpack_groups_var(*v32, ow)
    rec["bitpack_groups_var"]["launches"] = PK.bitpack_groups_var.launches
    if PK.bitpack_groups_var.launches != 1:
        fail("bitpack_groups_var: its phase did not launch the kernel once")
    if not torch.equal(v_words, PK.bitpack_groups_words(v_data, v_nbits, v_ends - v_nbits, ow)):
        fail("bitpack_groups_var: program B's AC words differ")
    log(f"bitpack_groups_var as program B's AC packer: {g} sections, words "
        f"equal to bitpack_groups_words")
    del v_data, v_nbits, v_ends, v_words, v32

    # Small images: both configurations byte for byte against the JAX
    # package's CPU streams (their sha256), as linear float and as u8 sRGB
    # (against the port's CPU streams); photo8mp as u8 sRGB against its CPU
    # stream; and the fixed-8x8 path through kernels and plain versions.
    t_gate = time.time()
    for label, config in (("default", cfg), ("fixed 8x8", cfg_8x8)):
        for upload, digests, what in (("float", JAX_CPU_DIGESTS, "the JAX package's"),
                                      ("u8", U8_CPU_DIGESTS, "the port's")):
            for name, (size, digest) in digests[label].items():
                img = load(name)
                if upload == "u8":
                    img = linear_to_srgb_u8(img)
                got = encode_image_device(img, DIST, config=config)
                sha = hashlib.sha256(got).hexdigest()
                log(f"encode {name} ({label}, {upload}): {len(got)} bytes, sha256 "
                    f"{sha[:16]}... against {what} CPU stream: {len(got) - size:+d} bytes, "
                    f"{'equal' if sha == digest else 'DIFFERENT'}")
                if sha != digest:
                    fail(f"{name} ({label}, {upload}): the card's {len(got)} B differ from "
                         f"{what} CPU stream ({size} B)")
    img8_u8 = linear_to_srgb_u8(img8)
    data_u8 = encode_image_device(img8_u8, DIST, config=cfg)
    sha_u8 = hashlib.sha256(data_u8).hexdigest()
    size, digest, tie = PHOTO8MP_U8
    log(f"encode photo8mp (default, u8): {len(data_u8)} bytes, sha256 {sha_u8} against "
        f"{size} B {digest[:16]}...: {'equal' if sha_u8 == digest else 'DIFFERENT'} ({tie})")
    if sha_u8 != digest:
        fail(f"photo8mp (u8): the card's {len(data_u8)} B differ from its digest ({size} B)")
    log(f"digest gates: 16 small-image encodes and photo8mp as u8 took "
        f"{time.time() - t_gate:.1f} s")
    crop = np.ascontiguousarray(img8[:, 512:1536, 1024:2048])
    reset_counts()
    c_k = encode_image_device(crop, DIST, config=cfg_8x8)
    launches_8x8 = {k: wr.launches for k, wr in wrappers.items()}
    if launches_8x8.pop("estimate_partials") or not all(launches_8x8.values()):
        fail(f"fixed 8x8: unexpected kernel launches: {launches_8x8}")
    if encode_image_device(crop, DIST, config=cfg_8x8, kernels=False) != c_k:
        fail("fixed 8x8: kernel encode differs from the plain versions' encode")
    log(f"encode photo8mp crop 1024x1024 (fixed 8x8): {len(c_k)} bytes, equal to "
        f"the plain-version encode on the card; launches {json.dumps(launches_8x8)}")

    # -- 4b. graphs: the compiled programs (ops/programs) --------------------
    graphs_phase(img8, data_k, data_st, data_u8, card, wrappers, reset_counts)
    torch.cuda.empty_cache()

    # -- 5. multi-image ----------------------------------------------------
    from jxl_tiny_tpu_torch import encoder as TE

    # (a) Program A and program B queue without a host sync, in both tiers.
    # A fault is reported with its traceback and fails the run after the
    # rest of this phase has run.
    sync_faults = []
    for label, config, want in (("default", cfg, data_k), ("static", cfg_static, data_st)):
        torch.cuda.synchronize()
        job = None
        try:
            torch.cuda.set_sync_debug_mode("error")
            job = DeviceEncodeJob([img8], DIST, config=config)
            torch.cuda.set_sync_debug_mode(0)
            job.pack()
            torch.cuda.set_sync_debug_mode("error")
            job._dispatch_b()
        except RuntimeError:
            sync_faults.append(label)
            log(f"multi-image: queueing program A / B ({label}) synchronized with the "
                f"host:\n{traceback.format_exc()}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if label in sync_faults:
            continue
        if job.result() != [want]:
            fail(f"sync-free job ({label}): bytes differ")
        log(f"multi-image: {label} tier, DeviceEncodeJob.__init__ and _dispatch_b "
            f"queued with no host sync (sync debug mode 'error'); bytes equal")
    del job
    torch.cuda.synchronize()

    def expect_launches(label, launches, a_runs, b_runs):
        """Each kernel once a program (kernel_check.expected_launches)."""
        want = KC.expected_launches(a_runs, b_runs)
        if not a_runs or launches != want:
            fail(f"{label}: launches {launches} are not once a program ({a_runs} A, "
                 f"{b_runs} B: {want})")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # (b) Pipelined: four 8 MP images against their serial encodes.
    imgs4 = stream_images(img8)
    mp4 = 4 * mp
    serial, t_ser = timed(lambda: [encode_image_device(im, DIST, config=cfg) for im in imgs4])
    if serial[0] != data_k:
        fail("photo8mp: serial encode differs from phase 4")
    if len(set(serial)) != 4:
        fail("the four 8 MP images did not give four different codestreams")
    retries0 = TE.RETRY_COUNT
    walls_p, walls_s = [], [t_ser]
    for turn in range(3):  # pipelined, pipelined, serial, pipelined
        reset_counts()
        piped, t_pipe = timed(lambda: list(TE.encode_images_device(imgs4, DIST, config=cfg)))
        walls_p.append(t_pipe)
        pipe_launches = {k: wr.launches for k, wr in wrappers.items()}
        if piped != serial:
            fail("encode_images_device: bytes or order differ from the serial encodes")
        if not all(pipe_launches.values()):
            fail(f"encode_images_device: a kernel of the path did not launch: {pipe_launches}")
        if turn == 1:
            _, t_ser2 = timed(lambda: [encode_image_device(im, DIST, config=cfg)
                                       for im in imgs4])
            walls_s.append(t_ser2)
    if TE.RETRY_COUNT != retries0 or TE.RETRY_COUNT:
        fail(f"encode_images_device retried {TE.RETRY_COUNT - retries0} images")
    ws, wp = statistics.median(walls_s), statistics.median(walls_p)
    prof = busy_share(lambda: list(TE.encode_images_device(imgs4, DIST, config=cfg)))
    log("pipelined photo8mp x4 under torch.profiler: " + (
        "no device time recorded" if prof is None else
        f"wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms "
        f"({100 * prof['busy_share']:.1f}%, idle {100 - 100 * prof['busy_share']:.1f}%); top "
        f"kernels (name, ms, calls) {prof['top']}")
        + f" [{card}]")
    log(f"multi-image: pipelined photo8mp x4 (photo8mp, its flips, its 180-degree turn; "
        f"{mp4:.2f} MP, default configuration, depth 3): serial walls "
        f"{[round(x * 1e3, 1) for x in walls_s]} ms, median {ws * 1e3:.1f} ms = "
        f"{mp4 / ws:.2f} MP/s; pipelined walls {[round(x * 1e3, 1) for x in walls_p]} ms, "
        f"median {wp * 1e3:.1f} ms = {mp4 / wp:.2f} MP/s; serial / pipelined "
        f"{ws / wp:.3f}; bytes equal and in input order, 0 retries; launches "
        f"{json.dumps(pipe_launches)} [{card}]")

    # Every kernel call of a batch, held against its plain version on the
    # same inputs (exact): the calls are recorded on a run of their own
    # (tools/kernel_check.recorded), and the comparison launches come
    # after the run's launch counts are read.
    def hold_calls(label, calls, time_ms=None):
        """Each recorded call's kernel output against its plain version;
        exits on any mismatch. Returns KC.hold_calls' record."""
        held = KC.hold_calls(calls, time_ms)
        for name, h_ in held.items():
            log(f"  {name} ({label}): {h_['calls']} calls at {h_['shapes']}: mismatches "
                f"{h_['mismatches']}, max_abs_err {h_['max_abs_err']}")
            if h_["mismatches"]:
                fail(f"{name} ({label}): kernel disagrees with its plain version in "
                     f"{h_['mismatches']} elements")
        return held

    # (c) Batched: eight 1024x1024 crops, float and u8 sRGB, both tiers.
    crops = eight_crops(img8)
    crops_u8 = [linear_to_srgb_u8(c) for c in crops]
    progs = ("analyze_batch_packed", "pack_batch_sections", "analyze_pack_batch_static")
    for label, batch, config in (("float, default", crops, cfg),
                                 ("u8 sRGB, default", crops_u8, cfg),
                                 ("float, static", crops, cfg_static),
                                 ("u8 sRGB, static", crops_u8, cfg_static)):
        singles, t_single = timed(lambda: [encode_image_device(c, DIST, config=config)
                                           for c in batch])
        TE.encode_batch_device(batch, DIST, config=config)  # warm
        runs, restore = KC.count_programs(TE, progs)
        reset_counts()
        try:
            got, t_batch = timed(lambda: TE.encode_batch_device(batch, DIST, config=config))
        finally:
            restore()
        launches = {k: wr.launches for k, wr in wrappers.items()}
        if got != singles:
            fail(f"encode_batch_device ({label}): bytes differ from the single encodes")
        static = not config.optimize_code
        a_runs = runs["analyze_pack_batch_static"] if static else runs["analyze_batch_packed"]
        b_runs = runs["analyze_pack_batch_static"] if static else runs["pack_batch_sections"]
        expect_launches(f"encode_batch_device ({label})", launches, a_runs, b_runs)
        got_r, calls, _ = KC.recorded(
            lambda: TE.encode_batch_device(batch, DIST, config=config))
        if got_r != singles:
            fail(f"encode_batch_device ({label}, recorded): bytes differ")
        errs = {k: h_["max_abs_err"]
                for k, h_ in hold_calls(f"8 crops, {label}", calls).items()}
        del calls
        if TE.encode_batch_device(batch, DIST, config=config, kernels=False) != singles:
            fail(f"encode_batch_device ({label}): the plain versions' batch encode differs")
        log(f"multi-image: batch of 8 crops 1024x1024 ({label}; 8.39 MP, 128 groups): "
            f"bytes equal to the single encodes ({sum(map(len, got))} B) and to the "
            f"plain versions' batch encode; every kernel call equal to its plain "
            f"version (max_abs_err {json.dumps(errs)}); single "
            f"encodes {t_single * 1e3:.1f} ms = {8 * 1.048576 / t_single:.2f} MP/s, "
            f"batch {t_batch * 1e3:.1f} ms = {8 * 1.048576 / t_batch:.2f} MP/s; "
            f"programs {json.dumps(runs)}; launches {json.dumps(launches)} [{card}]")

    # (d) The four 8 MP images as one batch: 540 groups, past copy_sections'
    # 512 groups of shared-memory offsets. Each kernel's calls are recorded,
    # held against their plain versions and timed at the batch's shapes
    # afterwards (device time of one batch's launches of that kernel). The
    # wall is taken on a run of its own: the recorded run keeps every kernel
    # input alive, so its tensors take fresh allocations.
    TE.encode_batch_device(imgs4, DIST, config=cfg)  # warm
    big, t_big = timed(lambda: TE.encode_batch_device(imgs4, DIST, config=cfg))
    if big != serial:
        fail("encode_batch_device (4 x 8 MP, 540 groups): bytes differ from the serial encodes")
    runs, restore = KC.count_programs(TE, progs)
    reset_counts()
    try:
        big, calls, _ = KC.recorded(lambda: TE.encode_batch_device(imgs4, DIST, config=cfg))
    finally:
        restore()
    launches = {k: wr.launches for k, wr in wrappers.items()}
    if big != serial:
        fail("encode_batch_device (4 x 8 MP, 540 groups): bytes differ from the serial encodes")
    expect_launches("encode_batch_device (4 x 8 MP)", launches, runs["analyze_batch_packed"],
                    runs["pack_batch_sections"])
    n_groups = calls["aq_field"][0][0].shape[0]
    sec_groups = [a[0].shape[0] for a in calls["copy_sections"]]
    if n_groups != 540 or max(sec_groups) <= 512:
        fail(f"the 8 MP batch ran {n_groups} groups, copy_sections at {sec_groups}")
    held = hold_calls("photo8mp x4, 540 groups", calls, lambda fn: device_time(fn, 5))
    errs = {name: h_["max_abs_err"] for name, h_ in held.items()}
    for name, err in errs.items():
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
    batch_ms = {name: sum(h_["ms"]) for name, h_ in held.items()}
    del calls
    torch.cuda.empty_cache()
    log(f"multi-image: batch of photo8mp x4 ({mp4:.2f} MP, {n_groups} groups; "
        f"copy_sections at {sec_groups} groups): bytes equal to the serial encodes; "
        f"every kernel call equal to its plain version (max_abs_err {json.dumps(errs)}); "
        f"wall {t_big * 1e3:.1f} ms = {mp4 / t_big:.2f} MP/s (serial {ws * 1e3:.1f} ms, "
        f"pipelined {wp * 1e3:.1f} ms); programs {json.dumps(runs)}; launches "
        f"{json.dumps(launches)} [{card}]")
    log(f"kernels at the 540-group batch's shapes (CUDA events, ms of one batch's "
        f"launches of each kernel): {json.dumps({k: round(v, 4) for k, v in batch_ms.items()})}"
        f" [{card}]")

    # -- 6. mesh: the multi-GPU path (jxl_tiny_tpu_torch/parallel/) ----------
    # Ranks are spawned processes (tools/multihost_dryrun.launch: kernels
    # built before, 60 s group timeout, a deadline a launch; a rank that
    # raises ends the launch and fails the run).
    import tempfile

    from jxl_tiny_tpu_torch.tools import multihost_dryrun as MD

    del big, serial, imgs4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    photo = ("pfm", os.path.join(HERE, "testdata", "photo8mp.pfm"), None, False)
    want = {"default": data_k, "static": data_st, "owner": data_k}

    def read_bins(d, names):
        out = {}
        for name in names:
            with open(os.path.join(d, f"{name}.bin"), "rb") as f:
                out[name] = f.read()
        return out

    def mesh_launches(label, rep_):
        """The launches of one mesh encode in a rank (counts set to 0 just
        before it, read just after) against the mesh programs it ran: each
        kernel once a program, the one-pass static program an A and a B."""
        runs = rep_["programs"]
        static = runs["analyze_pack_static_mesh"]
        expect_launches(f"{label}, programs {json.dumps(runs)}", rep_["launches"],
                        runs["analyze_image_packed_mesh"] + static,
                        runs["pack_all_sections_mesh"] + static)

    # (a) NCCL, one rank a card, over every card the machine has.
    n_gpu = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        MD.launch(n_gpu, MD.card_mesh_rank,
                  (photo, [(y, y + 1024, x, x + 1024) for y in (0, 1024)
                           for x in (0, 1024, 2048, 2816)], d),
                  device="cuda", backend="nccl", timeout_s=400)
        t_nccl = time.time() - t0
        got = read_bins(d, ("default", "static", "owner", "sync_default", "sync_static"))
        with open(os.path.join(d, "card.json")) as f:
            card_rep = json.load(f)
    for name, data in got.items():
        if data != want[name.replace("sync_", "")]:
            fail(f"mesh (NCCL, {n_gpu} rank(s)): {name} encode {len(data)} B differs from the "
                 f"single-card encode")
    mesh_launches(f"mesh (NCCL, {n_gpu} rank(s))", card_rep)
    for name in ("default", "static"):
        if not card_rep[f"batch_{name}"]["equal"]:
            fail(f"mesh (NCCL): the batch of 8 crops ({name}) differs from the one-card batch")
    wm = card_rep["wall_median_s"]
    log(f"mesh: NCCL over {n_gpu} card(s), world size {n_gpu}, one rank a card: photo8mp "
        f"(f16 ingest) default {len(got['default'])} B, static {len(got['static'])} B, owner "
        f"exchange {len(got['owner'])} B, all equal to encode_image_device; both tiers queued "
        f"(DeviceEncodeJob.__init__, _dispatch_b) with no host sync under sync debug mode "
        f"'error', bytes equal; 8 crops 1024x1024 through encode_batch_device(mesh=) equal "
        f"to the one-card batch (default {sum(card_rep['batch_default']['bytes'])} B, static "
        f"{sum(card_rep['batch_static']['bytes'])} B); launches of the default mesh encode "
        f"on rank 0 {json.dumps(card_rep['launches'])}, programs "
        f"{json.dumps(card_rep['programs'])}; launch {t_nccl:.1f} s [{card}]")
    log(f"mesh: world size {n_gpu} photo8mp walls (rank 0, host clock, 3 each): mesh "
        f"{[round(x * 1e3, 1) for x in card_rep['walls_s']['mesh']]} ms, median "
        f"{wm['mesh'] * 1e3:.1f} ms; encode_image_device "
        f"{[round(x * 1e3, 1) for x in card_rep['walls_s']['single']]} ms, median "
        f"{wm['single'] * 1e3:.1f} ms; mesh / single {wm['mesh'] / wm['single']:.3f} [{card}]")
    log(f"mesh: world size {n_gpu} photo8mp stages (rank 0, host clock, synced; ms): "
        + json.dumps({k: {s_: round(v_, 1) for s_, v_ in v.items()}
                      for k, v in card_rep["stages_ms"].items()}) + f" [{card}]")
    log(f"mesh: collectives at the encode's sizes, world size {n_gpu} (CUDA events, ms a "
        f"call; bytes each rank sends): " + json.dumps(
            {k: [round(v["ms"], 4), v["bytes_sent_a_rank"]]
             for k, v in card_rep["collectives"].items()}) + f" [{card}]")

    # (b) 2 and 4 ranks sharing card 0 over gloo (NCCL refuses two ranks on
    # one card).
    for n_ranks in (2, 4):
        record = (0, n_ranks - 1) if n_ranks == 4 else ()
        with tempfile.TemporaryDirectory() as d:
            t0 = time.time()
            MD.launch(n_ranks, MD.shared_card_rank,
                      (photo, d, ("default", "static", "owner"), record),
                      device="cuda:0", backend="gloo", timeout_s=400)
            t_gloo = time.time() - t0
            got = read_bins(d, ("default", "static", "owner") + (("recorded",) if record else ()))
            held = {}
            for r in record:
                with open(os.path.join(d, f"kernels_rank{r}.json")) as f:
                    held[r] = json.load(f)
        for name, data in got.items():
            if data != want.get(name, data_k):
                fail(f"mesh (gloo, {n_ranks} ranks on one card): {name} encode {len(data)} B "
                     f"differs from the single-card encode")
        log(f"mesh: {n_ranks} ranks sharing card 0 over gloo (on CUDA tensors): "
            f"photo8mp default {len(got['default'])} B, static {len(got['static'])} B, owner "
            f"exchange {len(got['owner'])} B, all equal to encode_image_device; launch "
            f"{t_gloo:.1f} s [{card}]")
        for r, rep_r in held.items():
            mesh_launches(f"mesh (gloo, {n_ranks} ranks, rank {r})", rep_r)
            for name, h_ in rep_r["held"].items():
                if h_["mismatches"]:
                    fail(f"mesh rank {r}: {name} disagrees with its plain version in "
                         f"{h_['mismatches']} elements")
                rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], h_["max_abs_err"])
            log(f"mesh: {n_ranks} ranks, rank {r}: every kernel call equal to its plain "
                f"version; shard-local shapes and kernel ms a call (CUDA events) " + json.dumps(
                    {k: [v["shapes"], [round(x, 4) for x in v["ms"]]]
                     for k, v in rep_r["held"].items()})
                + f"; launches {json.dumps(rep_r['launches'])}, programs "
                f"{json.dumps(rep_r['programs'])} [{card}]")

    if sync_faults:
        fail(f"queueing synchronized with the host in the {sync_faults} tier(s)")

    torch.cuda.empty_cache()
    verify_phase(img8, data_k, rec, card, dev, tables, hold_calls, reset_counts, wrappers)
    torch.cuda.empty_cache()
    debug_phase(img8, data_k, data_st, var_call, rec, card, dev, wrappers, args.trace_out)
    del var_call
    torch.cuda.empty_cache()
    configs_phase(img8, rec, card, dev, hold_calls, reset_counts, wrappers, expect_launches)
    torch.cuda.empty_cache()

    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def graphs_phase(img8, data_k, data_st, data_u8, card, wrappers, reset_counts):
    """Phase 4b: the compiled programs (ops/programs), see the module
    docstring. The reference encodes run inside programs.eager()."""
    import torch

    from jxl_tiny_tpu_torch import encoder as TE
    from jxl_tiny_tpu_torch.common import EncoderConfig
    from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
    from jxl_tiny_tpu_torch.ops import programs as PR
    from jxl_tiny_tpu_torch.tools import kernel_check as KC
    from jxl_tiny_tpu_torch.utils.profiling import busy_share, encode_report

    t_phase = time.time()
    cfg, cfg_8x8 = EncoderConfig(), EncoderConfig(optimize_block_sizes=False)
    cfg_static = EncoderConfig(optimize_code=False)
    progs = ("analyze_batch_packed", "pack_batch_sections", "analyze_pack_batch_static")
    calls = ("eager", "captures", "replays")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def run(label, fn, static=False, expect=None, blocks=True):
        """fn() with its launches (counts set to 0 just before, read just
        after), held to once a program run (eager calls and replays; no
        estimate_partials without the block-size search); the cache's
        first calls (eager), captures and replays during it; expect: "first"
        (a first call and no capture; a program whose key an earlier call
        shares replays), "capture" (at least one capture), "replay"
        (replays only) or "eager" (no cache)."""
        runs, restore = KC.count_programs(TE, progs)
        before = PR.stats()
        reset_counts()
        try:
            out, wall = timed(fn)
        finally:
            restore()
        after = PR.stats()
        launches = {k: w.launches for k, w in wrappers.items()}
        c = {k: after[k] - before[k] for k in calls}
        a = runs["analyze_pack_batch_static"] if static else runs["analyze_batch_packed"]
        b = runs["analyze_pack_batch_static"] if static else runs["pack_batch_sections"]
        want = KC.expected_launches(a, b)
        if not blocks:
            want["estimate_partials"] = 0
        if not a or launches != want:
            fail(f"graphs: {label}: launches {launches} are not once a program ({runs})")
        due = {"first": not c["eager"] or c["captures"],
               "capture": not c["captures"],
               "replay": c["eager"] or c["captures"] or not c["replays"],
               "eager": any(c.values())}
        if due.get(expect, False):
            fail(f"graphs: {label}: {json.dumps(c)} where {expect} was due")
        return out, wall, launches, dict(runs=runs, **c)

    # (a) photo8mp: eager, then the first call (eager by rule), the capture
    # and two replays, each equal to phase 4's bytes with the eager
    # launches; then one more replay traced, its kernels counted by name.
    PR.clear_programs()
    img8_u8 = linear_to_srgb_u8(img8)
    for label, img, config, want in (("default, float16", img8, cfg, data_k),
                                      ("static, float16", img8, cfg_static, data_st),
                                      ("default, u8", img8_u8, cfg, data_u8)):
        static = not config.optimize_code

        def encode():
            return TE.encode_image_device(img, DIST, config=config)

        with PR.eager():
            got, t_eager, l_eager, _ = run(f"photo8mp ({label}, eager)", encode, static, "eager")
        if got != want:
            fail(f"graphs: photo8mp ({label}): the eager encode differs from phase 4's")
        walls, counts = [], []
        for call in ("first", "capture", "replay", "replay"):
            got, wall, launches, c = run(f"photo8mp ({label}, {call})", encode, static, call)
            if got != want or launches != l_eager:
                fail(f"graphs: photo8mp ({label}, {call}): {len(got)} B against phase 4's "
                     f"{len(want)} B; launches {launches} against eager {l_eager}")
            walls.append(round(wall * 1e3, 1))
            counts.append("/".join(str(c[k]) for k in calls))
        before = PR.stats()
        reset_counts()
        got, traced = KC.traced_launches(encode)
        launches = {k: w.launches for k, w in wrappers.items()}
        if PR.stats()["replays"] == before["replays"] or got != want or traced != launches:
            fail(f"graphs: photo8mp ({label}): a traced replay ran kernels {traced} where "
                 f"the wrappers counted {launches}")
        log(f"graphs: photo8mp ({label}): {len(want)} bytes, sha256 "
            f"{hashlib.sha256(want).hexdigest()[:16]}..., equal to phase 4's eager encode on "
            f"the first call, the capture and two replays; launches equal the eager run's "
            f"{json.dumps(l_eager)}, and a traced replay's kernels (torch.profiler, by name) "
            f"equal the counts; calls (first calls/captures/replays) {counts}; walls eager "
            f"{t_eager * 1e3:.1f} ms, first call, capture, replay, replay {walls} ms [{card}]")

    # (b) The small images' digests: first calls, captures and replays.
    t0, n = time.time(), 0
    for label, config in (("default", cfg), ("fixed 8x8", cfg_8x8)):
        for upload, digests in (("float", JAX_CPU_DIGESTS), ("u8", U8_CPU_DIGESTS)):
            for name, (size, digest) in digests[label].items():
                img = load(name)
                if upload == "u8":
                    img = linear_to_srgb_u8(img)
                for call in ("first", "capture", "replay"):
                    got, _, _, c = run(f"{name} ({label}, {upload}, {call})",
                                       lambda: TE.encode_image_device(img, DIST, config=config),
                                       expect=call, blocks=config.optimize_block_sizes)
                    if hashlib.sha256(got).hexdigest() != digest:
                        fail(f"graphs: {name} ({label}, {upload}, {call}): {len(got)} B differ "
                             f"from the digest ({size} B)")
                    n += 1
    log(f"graphs: the 16 small-image encodes of phase 4, each as a first call, a capture and "
        f"a replay: every sha256 equal to its digest ({n} encodes, {time.time() - t0:.1f} s)")

    # (c) The depth-3 stream and the batch of eight crops, as replays.
    imgs4 = stream_images(img8)
    with PR.eager():
        serial = [TE.encode_image_device(im, DIST, config=cfg) for im in imgs4]
    if serial[0] != data_k:
        fail("graphs: the eager serial encode of photo8mp differs from phase 4's")
    piped, t_piped, launches, c = run("stream of 4 (replays)", lambda: list(
        TE.encode_images_device(imgs4, DIST, config=cfg)), expect="replay")
    if piped != serial:
        fail("graphs: the depth-3 stream differs from the eager serial encodes")
    log(f"graphs: stream of photo8mp x4 at depth 3 on one graph a program: bytes equal to the "
        f"eager serial encodes ({c['replays']} replays, 0 captures); launches "
        f"{json.dumps(launches)}, programs {json.dumps(c['runs'])}; wall {t_piped * 1e3:.1f} "
        f"ms [{card}]")
    batch = eight_crops(img8)
    with PR.eager():
        want = TE.encode_batch_device(batch, DIST, config=cfg)
    first = [TE.encode_batch_device(batch, DIST, config=cfg) for _ in range(2)]
    got, t_batch, launches, c = run("batch of 8 crops (replays)", lambda: TE.encode_batch_device(
        batch, DIST, config=cfg), expect="replay")
    if first != [want, want] or got != want:
        fail("graphs: the batch of 8 crops differs from its eager encode")
    log(f"graphs: batch of 8 crops 1024x1024: bytes equal to the eager batch as a first call, "
        f"a capture and a replay ({c['replays']} replays); launches {json.dumps(launches)}; "
        f"wall {t_batch * 1e3:.1f} ms [{card}]")
    del imgs4, serial, piped, batch

    # (d) Traffic that repeats no key: six u8 crops of six sizes, each once,
    # eager and from the cache (every call a first call: nothing captured),
    # then the same six twice more (captures, then replays).
    sizes = ((768, 1024), (720, 1280), (1024, 1536), (1080, 1920), (1536, 2048), (1440, 2560))
    varied = [np.ascontiguousarray(img8_u8[:, :h, :w]) for h, w in sizes]

    def encode_all():
        return [TE.encode_image_device(im, DIST, config=cfg) for im in varied]

    with PR.eager():
        want, t_eager = timed(encode_all)
    PR.clear_programs()
    passes = {}
    for call in ("first", "capture", "replay"):
        before = PR.stats()
        got, passes[call] = timed(encode_all)
        c = {k: PR.stats()[k] - before[k] for k in calls}
        if got != want or (call == "first" and c["captures"]):
            fail(f"graphs: six sizes ({call}): bytes differ from eager, or {json.dumps(c)}")
        passes[call] = [round(passes[call] * 1e3, 1), c]
    log(f"graphs: six u8 crops of six sizes {[f'{w}x{h}' for h, w in sizes]}, bytes equal to "
        f"eager in every pass: walls of the six (ms, host clock, with first calls/captures/"
        f"replays) eager {t_eager * 1e3:.1f}, first calls {json.dumps(passes['first'])}, "
        f"captures {json.dumps(passes['capture'])}, replays {json.dumps(passes['replay'])} "
        f"[{card}]")
    del varied

    # (e) Eager against replay: the programs' device ms and host queueing
    # (encode_report), the e2e walls, the device-resident A+B and its busy
    # share; each key's first call ms, capture ms and pool bytes.
    _, rep = encode_report(img8, DIST, repeats=3, config=cfg)
    fig = {}
    for mode in ("eager", "graphs"):
        ctx = PR.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            walls = {}
            for upload, img in (("float16", img8), ("u8", img8_u8)):
                for _ in range(2):  # warm: a first call, then a capture
                    TE.encode_image_device(img, DIST)
                walls[upload] = statistics.median(
                    timed(lambda: TE.encode_image_device(img, DIST))[1] for _ in range(4))
            job = TE.DeviceEncodeJob([img8_u8], DIST)
            if job.result() != [data_u8]:
                fail(f"graphs: the resident job ({mode}) differs from the u8 encode")

            def once():
                job._packed = False
                job._start_a()
                job.pack()
                return job._small_sync()

            resident = statistics.median(timed(once)[1] for _ in range(4))
            share = busy_share(once)
        fig[mode] = dict(e2e_f16_ms=round(walls["float16"] * 1e3, 2),
                         e2e_u8_ms=round(walls["u8"] * 1e3, 2),
                         resident_ms=round(resident * 1e3, 2),
                         busy_share=None if share is None else round(share["busy_share"], 4))
    queue = {mode: {k: src.get(k) for k in ("program_a_ms", "program_a_queue_ms",
                                            "program_b_ms", "program_b_queue_ms",
                                            "program_ms_are")}
             for mode, src in (("eager", rep["eager"]), ("graphs", rep))}
    log(f"graphs: photo8mp eager against replay (median of 4, host clock; program ms CUDA "
        f"events, queue ms the host's time to queue one call): "
        f"{json.dumps({m: {**fig[m], **queue[m]} for m in fig})} [{card}]")
    keys = [k for k in PR.stats()["by_key"] if str(img8.shape[1]) in k["key"]
            or "[135" in k["key"]]
    log("graphs: photo8mp's program keys (the first call's host ms, capture ms and pool bytes "
        "a capture, replays): " + json.dumps(
            [{"key": k["key"], "first_call_ms": None if k["warm_ms"] is None
              else round(k["warm_ms"], 1), "captures": k["captures"], "replays": k["replays"],
              "capture_ms": [round(x, 1) for x in k["capture_ms"]],
              "pool_bytes": k["pool_bytes"]} for k in keys]) + f" [{card}]")
    st = PR.stats()
    PR.clear_programs()
    log(f"graphs: the cache held {st['programs']} programs, {st['pool_bytes']} pool bytes; "
        f"{st['eager']} first calls, {st['captures']} captures, {st['replays']} replays, "
        f"{st['evictions']} evictions; cleared; phase 4b took {time.time() - t_phase:.1f} s "
        f"[{card}]")


def verify_phase(img8, data_k, rec, card, dev, tables, hold_calls, reset_counts,
                 wrappers):
    """Phase 7: the host-packed path, the numpy golden model and the
    decoder on the card's machine (see the module docstring)."""
    import torch

    from jxl_tiny_tpu_torch import encoder as TE
    from jxl_tiny_tpu_torch.bitstream import sections as S
    from jxl_tiny_tpu_torch.common import compute_distance_params
    from jxl_tiny_tpu_torch.decode import decode_jxl
    from jxl_tiny_tpu_torch.ops import pack_kernels as PK
    from jxl_tiny_tpu_torch.ops import pipeline as PL
    from jxl_tiny_tpu_torch.ops import pipeline_full as PF
    from jxl_tiny_tpu_torch.tools import kernel_check as KC
    from jxl_tiny_tpu_torch.utils.profiling import StageTimer, device_time

    t_phase = time.time()
    on_path = ("aq_field", "estimate_partials")

    def host_encode(img, **kw):
        return TE.encode_image_host_packed(img, DIST, **kw)

    # (a) photo8mp through the host-packed path, float32 and float16 upload:
    # launches counted from 0 just before the encode and read just after,
    # every kernel call recorded and held against its plain version.
    host = {}
    for label, up in (("float32", None), ("float16", np.float16)):
        host_encode(img8, upload_dtype=up)  # warm
        reset_counts()
        data, calls, launches = KC.recorded(lambda: host_encode(img8, upload_dtype=up))
        host[label] = data
        retry = launches["aq_field"] == 2
        off_path = {k: v for k, v in launches.items() if k not in on_path and v}
        if any(not launches[k] for k in on_path) or off_path:
            fail(f"host-packed path ({label}): unexpected launches {launches}")
        if label == "float32":
            for k, r in rec.items():  # bitpack_groups_var: its own counter
                r["launches_host_packed"] = launches.get(k, PK.bitpack_groups_var.launches)
        held = hold_calls(f"host-packed photo8mp, {label} upload",
                          {k: calls[k] for k in on_path})
        for k, h_ in held.items():
            rec[k]["max_abs_err"] = max(rec[k]["max_abs_err"], h_["max_abs_err"])
        del calls
        if host_encode(img8, upload_dtype=up, kernels=False) != data:
            fail(f"host-packed photo8mp ({label}): bytes differ from the plain versions'")
        log(f"verify: host-packed photo8mp ({label} upload): {len(data)} bytes, equal to "
            f"the plain versions' host-packed encode; launches {json.dumps(launches)}; "
            f"cap retry {'ran (a group past 16,384 tokens)' if retry else 'not needed'}")

    # The cap retry on the card: at cap 1000 gradient512's analysis runs at
    # 1000, finds a group past it and runs again at FULL_CAP; the bytes are
    # the uncapped call's.
    grad = load("gradient512")
    caps, fast = [], PF.analyze_image_fast

    def spy(image, yb_, xb_, distp_, cap, tables_, kernels=True):
        caps.append(cap)
        return fast(image, yb_, xb_, distp_, cap, tables_, kernels)

    PF.analyze_image_fast = spy
    try:
        capped = host_encode(grad, cap=1000)
    finally:
        PF.analyze_image_fast = fast
    uncapped = host_encode(grad)
    if caps != [1000, PF.FULL_CAP] or capped != uncapped:
        fail(f"host-packed gradient512 at cap 1000: analyses at caps {caps}, {len(capped)} B "
             f"against {len(uncapped)} B uncapped")
    log(f"verify: host-packed gradient512 at cap 1000: analyses at caps {caps} (the retry at "
        f"FULL_CAP), {len(capped)} bytes, equal to the uncapped call's")

    # The device-packed and host-packed analyses of the same float16 upload
    # hold the same quantized image: equal maps, totals and token values
    # (the contexts differ: base-64 clusters against the full 1980).
    distp = compute_distance_params(DIST)
    up16 = TE.upload_pixels(img8, np.dtype(np.float16), dev)
    yb, xb = PL.group_valid_blocks(img8.shape[1], img8.shape[2], dev)
    d_out = PL.analyze_groups_packed(PL.extract_groups_device(up16), yb, xb, distp, 32768,
                                     tables)
    h_out = PF.analyze_image_fast(up16, yb, xb, distp, 32768, tables)
    keys = ("quant_dc", "raw_qf", "strategy", "is_first", "ytox", "ytob")
    same = {k: torch.equal(a.long(), h_out[k].long()) for k, a in zip(keys, d_out["maps"])}
    same["totals"] = torch.equal(d_out["totals"].long(), h_out["totals"].long())
    pos = torch.arange(32768, device=dev)[None, :] < h_out["totals"][:, None]
    same["token values"] = torch.equal(torch.where(pos, d_out["stream"][:, :32768] & 0xFFFF, 0),
                                       torch.where(pos, h_out["stream"] & 0xFFFF, 0))
    if not all(same.values()):
        fail(f"photo8mp float16: device-packed and host-packed analyses differ: {same}")
    log(f"verify: photo8mp float16 upload: device-packed and host-packed analyses equal "
        f"({', '.join(same)}; {int(h_out['totals'].sum())} tokens)")
    del d_out, h_out, up16

    # The numpy golden model on this machine's host, its group analyses
    # kept and compared group by group with the host-packed analysis
    # (float32): an independent float implementation, so a few decisions
    # at rounding ties may differ (on the CPU, the JAX package's own
    # encode_image_jax differs from its golden model in 8 of photo8mp's
    # 135 groups, the port's in 5); more than a tenth of the groups would
    # be a fault, not a tie.
    gold_groups = {}

    def golden_analyze(img, gx, gy, distp_):
        gold_groups[(gy, gx)] = TE.analyze_group_numpy(img, gx, gy, distp_)
        return gold_groups[(gy, gx)]

    t0 = time.time()
    golden = TE.encode_image(img8, DIST, analyze_fn=golden_analyze)
    t_golden = time.time() - t0
    out = TE.analyze_host_packed(img8, distp)
    dim = TE.ImageDim(img8.shape[2], img8.shape[1])
    differing = []
    for i, (gy, gx) in enumerate((gy, gx) for gy in range(dim.ysize_groups)
                                 for gx in range(dim.xsize_groups)):
        g = gold_groups[(gy, gx)]
        ty, tx = g.ytox.shape
        n_map = sum(int((np.asarray(getattr(g, k)).astype(np.int64) != v.astype(np.int64)).sum())
                    for k, v in (("strategy", out["strategy"][i, :g.yb, :g.xb]),
                                 ("is_first", out["is_first"][i, :g.yb, :g.xb]),
                                 ("raw_qf", out["raw_qf"][i, :g.yb, :g.xb]),
                                 ("quant_dc", out["quant_dc"][i, :, :g.yb, :g.xb]),
                                 ("ytox", out["ytox"][i, :ty, :tx]),
                                 ("ytob", out["ytob"][i, :ty, :tx])))
        ctx, val = S.ac_group_token_stream(g.tokens, g.counts, g.strategy, g.is_first)
        gs = (ctx.astype(np.uint32) << 16) | val
        hs = out["stream"][i, : int(out["totals"][i])]
        n = min(len(gs), len(hs))
        n_tok = int((gs[:n] != hs[:n]).sum()) + abs(len(gs) - len(hs))
        if n_map or n_tok:
            differing.append([i, n_map, n_tok])
    log(f"verify: numpy golden model (encode_image) photo8mp: {len(golden)} bytes "
        f"(host-packed {len(host['float32'])}), wall {t_golden:.2f} s (this machine's "
        f"host); groups whose maps or tokens differ from the host-packed analysis "
        f"(group, map values, token positions): {len(differing)} of {dim.num_groups} "
        f"{differing}")
    if len(differing) > dim.num_groups // 10:
        fail(f"the numpy golden model and the host-packed path differ in {len(differing)} "
             f"of {dim.num_groups} groups")

    # (b) The full (fast=False) route and make_analyze_fn on a 1024x1024 crop.
    crop = np.ascontiguousarray(img8[:, 512:1536, 1024:2048])
    fast_b = host_encode(crop)
    reset_counts()
    full_b = host_encode(crop, fast=False)
    full_launches = {k: wrappers[k].launches for k in on_path}
    per_group = TE.encode_image(crop, DIST, analyze_fn=PF.make_analyze_fn())
    if not (full_b == per_group == fast_b) or not all(full_launches.values()):
        fail(f"crop 1024x1024: full route {len(full_b)} B, make_analyze_fn {len(per_group)} "
             f"B, fast route {len(fast_b)} B; full-route launches {full_launches}")
    log(f"verify: crop 1024x1024: full route (fast=False; launches "
        f"{json.dumps(full_launches)}) and make_analyze_fn (16 one-group analyses) equal "
        f"the fast route's {len(fast_b)} bytes")

    # (c) The port's decoder: three images through all three pipelines.
    t_dec = {}
    for name, ref_psnr in GOLDEN_PSNR.items():
        img = load(name)
        streams = {"device": TE.encode_image_device(img, DIST), "host": host_encode(img),
                   "numpy": TE.encode_image(img, DIST)}
        pix, ps = {}, {}
        for pipe, data in streams.items():
            t0 = time.time()
            pix[pipe] = decode_jxl(data)
            t_dec[f"{name} {pipe}"] = time.time() - t0
            ps[pipe] = psnr(pix[pipe], img)
            if not ps[pipe] > ref_psnr - 0.1:
                fail(f"{name} ({pipe}): {ps[pipe]:.3f} dB is not above {ref_psnr} - 0.1")
        if not np.array_equal(pix["device"], pix["host"]):
            fail(f"{name}: the device and host streams decode to different pixels")
        log(f"verify: {name}: sizes " + json.dumps({k: len(v) for k, v in streams.items()})
            + ", PSNR (dB) " + json.dumps({k: round(v, 3) for k, v in ps.items()})
            + f" > {ref_psnr} - 0.1; device and host pixels bit-identical")

    # photo8mp: the default device encode and the golden stream, once each.
    t0 = time.time()
    p_dev = psnr(decode_jxl(data_k), img8)
    t_dec["photo8mp device"] = time.time() - t0
    t0 = time.time()
    p_gold = psnr(decode_jxl(golden), img8)
    t_dec["photo8mp numpy"] = time.time() - t0
    if abs(p_dev - p_gold) > 0.1:
        fail(f"photo8mp: device stream {p_dev:.3f} dB vs golden {p_gold:.3f} dB")
    log(f"verify: photo8mp decoded by the port: device stream ({len(data_k)} B, float16 "
        f"upload) {p_dev:.3f} dB, golden stream ({len(golden)} B) {p_gold:.3f} dB; decoder "
        f"walls (s) " + json.dumps({k: round(v, 3) for k, v in t_dec.items()}))

    # (d) The host path's warm wall, and one encode split into its stages
    # (host clock; the stages that queue device work synchronize first).
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if host_encode(img8) != host["float32"]:
            fail("host-packed photo8mp: repeated encodes differ")
        walls.append(time.perf_counter() - t0)
    timer = StageTimer()

    def timed(module, name, sync, label):
        # module.<name> timed as the stage `label`; with sync, the clock
        # stops after the card's work. Returns what puts it back.
        real = getattr(module, name)

        def call(*args, **kwargs):
            with timer.stage(label):
                out = real(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
            return out

        setattr(module, name, call)
        return lambda: setattr(module, name, real)

    restores = [timed(m_, n_, sync, label) for label, (m_, n_, sync) in {
        "upload": (TE, "upload_pixels", True),
        "analysis": (PF, "analyze_image_fast", True),
        "stream download": (TE, "host_arrays", False),
        "DC sections' ops": (TE, "_build_dc_group", False),
        "histograms": (S, "histogram_sections", False),
        "codes": (TE, "build_entropy_code", False),
        "serialization": (S, "serialize_section", False),
    }.items()]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = host_encode(img8)
        total = time.perf_counter() - t0
    finally:
        for restore in restores:
            restore()
    if data != host["float32"]:
        fail("host-packed photo8mp: the staged encode differs")
    spent = dict(timer.stages)
    spent["assembly (group maps, headers, TOC, packing)"] = total - sum(spent.values())
    dim = TE.ImageDim(img8.shape[2], img8.shape[1])
    yb, xb = (torch.from_numpy(a).to(dev) for a in TE._valid_blocks(dim))
    up = TE.upload_pixels(img8, np.dtype(np.float32), dev)
    a_ms = device_time(lambda: PF.analyze_image_fast(up, yb, xb, distp, 16384, tables),
                           3, 1)
    out = TE.host_arrays(PF.analyze_image_fast(up, yb, xb, distp, 16384, tables))
    nbytes = sum(v.nbytes for v in out.values())
    mp = img8.shape[1] * img8.shape[2] / 1e6
    wall = statistics.median(walls)
    log(f"verify: host-packed photo8mp (float32 upload, cap 16384): warm wall median of 3 "
        f"{wall * 1e3:.1f} ms ({[round(w_ * 1e3, 1) for w_ in walls]}), {mp / wall:.2f} MP/s; "
        f"analysis {a_ms:.3f} ms (CUDA events); download {nbytes} bytes; stages (ms) "
        + json.dumps({k: round(v * 1e3, 1) for k, v in spent.items()})
        + f", total {total * 1e3:.1f} ms [{card}]")
    log(f"verify: phase 7 took {time.time() - t_phase:.1f} s")



def debug_phase(img8, data_k, data_st, var_call, rec, card, dev, wrappers, trace_out):
    """Phase 8: the checked build, debug mode, the exactness probe and its
    two kernels, and encode_report (see the module docstring)."""
    import gzip
    import shutil

    import torch

    from jxl_tiny_tpu_torch import encoder as TE
    from jxl_tiny_tpu_torch.common import EncoderConfig
    from jxl_tiny_tpu_torch.ops import _build
    from jxl_tiny_tpu_torch.ops import probe_kernels as PBK
    from jxl_tiny_tpu_torch.tools import bench_probe as BP
    from jxl_tiny_tpu_torch.tools import checked_kernels as CK
    from jxl_tiny_tpu_torch.tools import kernel_check as KC
    from jxl_tiny_tpu_torch.tools import probe_op_exactness as PO
    from jxl_tiny_tpu_torch.utils import debug_mode, encode_report, profile_trace
    from jxl_tiny_tpu_torch.utils.profiling import device_time

    t_phase = time.time()
    probes = (PBK.probe_elementwise, PBK.probe_dot_i8)
    counted = (*wrappers.values(), *probes)

    def walled(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # (0) The checked build (ops/_build.CHECKED_FLAGS: csrc/check.cuh's
    # bounds checks) of the six encode sources, all nvcc processes at once,
    # and every source's registers and spill bytes at both flag sets.
    t0 = time.time()
    checked = _build.build_all(_build.CHECKED_FLAGS, _build.CHECKED_SOURCES)
    if sorted(checked) != sorted(_build.CHECKED_SOURCES):
        fail(f"checked build: libraries {sorted(checked)}")
    log(f"debug: checked build of {len(checked)} sources ({', '.join(sorted(checked))}) in "
        f"{time.time() - t0:.1f} s, into {_build.build_dir(_build.CHECKED_FLAGS)}")
    try:
        ptx = CK.ptxas_report({"normal": _build.NVCC_FLAGS, "checked": _build.CHECKED_FLAGS})
    except RuntimeError as e:
        fail(f"ptxas report: {e}")
    for src, r in ptx.items():
        log(f"debug: ptxas {src}.cu ({r['normal']['kernels']} kernels; the most registers a "
            f"kernel, spill bytes of all): normal {r['normal']['registers']} registers, "
            f"{r['normal']['spill_bytes']} B spilled; checked {r['checked']['registers']} "
            f"registers, {r['checked']['spill_bytes']} B spilled")

    # (0') Phase 3's calls through the checked build: every call the
    # photo8mp encode makes of the six encode kernels (recorded, so at the
    # shapes phase 3 holds) and bitpack_groups_var on program B's AC tokens
    # (phase 3's call). Each equals the normal build and the plain version
    # with no fault recorded; both builds timed call by call (CUDA events,
    # the checked build without its read-back after each launch).
    got, calls, _ = KC.recorded(lambda: TE.encode_image_device(img8, DIST))
    if got != data_k:
        fail("checked build: the recorded photo8mp encode differs from phase 4's")
    calls["bitpack_groups_var"] = [var_call]
    for name in list(calls):
        try:
            h_ = CK.hold_checked(name, calls.pop(name), lambda fn: device_time(fn, 10))
        except IndexError as e:
            fail(f"checked build, {name} at photo8mp's shapes: {e}")
        if h_["mismatches_normal"] or h_["mismatches_plain"]:
            fail(f"checked build, {name}: {h_['mismatches_normal']} elements differ from the "
                 f"normal build, {h_['mismatches_plain']} from the plain version")
        rec[name]["checked"] = dict(ms=h_["checked_ms"], normal_ms=h_["ms"], shapes=h_["shapes"])
        ratio = [round(c / n_, 3) for c, n_ in zip(h_["checked_ms"], h_["ms"])]
        log(f"debug: checked {name}: {h_['calls']} calls at {h_['shapes']}, equal to the normal "
            f"build and the plain version, no fault; ms checked "
            f"{[round(x, 4) for x in h_['checked_ms']]} against normal "
            f"{[round(x, 4) for x in h_['ms']]} ({ratio}x) [{card}]")
        torch.cuda.empty_cache()
    del calls

    # (0'') One injected fault a kernel on gradient512's calls
    # (tools/checked_kernels.inject): the launcher called directly with one
    # output's extent one element short and a canary tail after it.
    small = CK.small_calls(dev)
    for name in CK.INJECT:
        r = CK.inject(name, small[name][0])
        f = r["fault"]
        log(f"debug: injected fault, {name}: "
            + ("no fault reported" if f is None else _build.fault_message(f))
            + f"; guard lines of the cut buffer {r['expected_lines']}; canary "
            f"{'intact' if r['canary_intact'] else 'OVERWRITTEN'}; the next normal launch "
            f"{'equal to' if not r['normal_after'] else 'DIFFERS from'} the plain version")
        if not r["ok"]:
            fail(f"injected fault, {name}: {r}")
    del small

    # (a) Debug mode (NaN checks after each float stage of program A, the
    # checked kernels), and with kernels=False (the plain versions on the
    # card): the bytes of the same encode outside it; every kernel of the
    # path launched in the first, none in the second.
    tiers = {"default": EncoderConfig(), "static": EncoderConfig(optimize_code=False)}
    cases = [(n, t) for n in ("photo256", "gradient512", "odd131x77", "photo8mp") for t in tiers]
    for name, tier in cases:
        img = img8 if name == "photo8mp" else load(name)

        def encode(kernels=True):
            return TE.encode_image_device(img, DIST, config=tiers[tier], kernels=kernels)

        encode()  # warm
        want, t_normal = walled(encode)
        walls = {}
        for kernels in (True, False):
            for wr in counted:
                wr.launches = 0
            with debug_mode():
                got, walls[kernels] = walled(lambda: encode(kernels))
            launched = {k: wr.launches for k, wr in wrappers.items()}
            if got != want:
                fail(f"debug mode, {name} ({tier}, kernels={kernels}): {len(got)} B against "
                     f"{len(want)} B outside it")
            if (all(launched.values()) if kernels else any(launched.values())) != kernels:
                fail(f"debug mode, {name} ({tier}, kernels={kernels}): launches {launched}")
        if name == "photo8mp" and want != {"default": data_k, "static": data_st}[tier]:
            fail(f"debug mode, photo8mp ({tier}): bytes differ from phase 4's encode")
        log(f"debug: debug mode {name} ({tier}): {len(want)} bytes on the checked kernels and on "
            f"their plain versions (kernels=False, no launch), equal to the encode outside it; "
            f"no NaN, no out-of-bounds access; "
            f"walls {walls[True]:.1f} ms (kernels), {walls[False]:.1f} ms (plain) against "
            f"{t_normal:.1f} ms ({walls[True] / t_normal:.2f}x, {walls[False] / t_normal:.2f}x) "
            f"[{card}]")

    # (b) The exactness probe and its two kernels. The probe's run is this
    # phase's path: counts set to 0 just before, read just after.
    for wr in probes:
        wr.launches = 0
    cols = PO.probe(dev)
    dot_vs_ref, dot_vs_plain = PO.probe_dot(dev)
    probe_launches = {"probe_elementwise": PBK.probe_elementwise.launches,
                      "probe_dot_i8": PBK.probe_dot_i8.launches}
    for op, row in cols.items():
        log(f"debug: probe {op} (share of {1 << 19} values differing, max ulp; columns against "
            f"the float64 reference rounded once, kernel_vs_plain: the port-flag kernel against "
            f"torch on the card): {json.dumps(row)} [{card}]")
    inexact = [op for op in PO.EQUAL_ON_CARD if cols[op]["kernel_vs_plain"] != [0.0, 0]]
    if inexact:
        fail(f"probe_elementwise disagrees with its plain version on {inexact}")
    if dot_vs_ref or dot_vs_plain:
        fail(f"probe_dot_i8: {dot_vs_ref} elements differ from the int32 product, "
             f"{dot_vs_plain} from the plain version")
    log(f"debug: probe_dot_i8 [256,128] x [128,128] int8 -> int32: equal to the numpy int32 "
        f"product and to its plain version; launches in the probe's run "
        f"{json.dumps(probe_launches)}")

    # Times at the probe's shapes (CUDA events): probe_elementwise on div
    # over the 2^19 values (two inputs read, one output written), and
    # probe_dot_i8 on the one-hot permutation.
    x, y, _, q, perm = PO.probe_inputs(19)
    a, b = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    err = compare("probe_elementwise (div, timed)", [PBK.probe_elementwise("div", a, b)],
                  [PBK.probe_elementwise_plain("div", a, b)])
    ms = device_time(lambda: PBK.probe_elementwise("div", a, b), 50)
    pms = device_time(lambda: PBK.probe_elementwise_plain("div", a, b), 50)
    lms = device_time(lambda: torch.div(a, b), 50)
    b_ms, b_by = bound(3 * a.numel() * 4, a.numel())
    rec["probe_elementwise"] = dict(
        name="probe_elementwise", route="cuda", source="jxl_tiny_tpu_torch/csrc/probe.cu",
        replaces="tools/probe_op_exactness.py:36", launches=probe_launches["probe_elementwise"],
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms)
    qa, qb = torch.from_numpy(q).to(dev), torch.from_numpy(perm).to(dev)
    err = compare("probe_dot_i8 (timed)", [PBK.probe_dot_i8(qa, qb)],
                  [PBK.probe_dot_i8_plain(qa, qb)])
    if not torch.equal(torch._int_mm(qa, qb), PBK.probe_dot_i8_plain(qa, qb)):
        fail("probe_dot_i8: the torch._int_mm yardstick computes something else")
    ms = device_time(lambda: PBK.probe_dot_i8(qa, qb), 50)
    pms = device_time(lambda: PBK.probe_dot_i8_plain(qa, qb), 50)
    lms = device_time(lambda: torch._int_mm(qa, qb), 50)
    b_ms, b_by = BP.dot_bound(*qa.shape, qb.shape[1])
    rec["probe_dot_i8"] = dict(
        name="probe_dot_i8", route="cuda", source="jxl_tiny_tpu_torch/csrc/probe.cu",
        replaces="tools/probe_op_exactness.py:152", launches=probe_launches["probe_dot_i8"],
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms)
    for k in ("probe_elementwise", "probe_dot_i8"):
        r = rec[k]
        log(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms ({'torch.div' if k == 'probe_elementwise' else 'torch._int_mm'}), "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}) [{card}]")

    # (b') Both kernels at photo8mp's shapes (tools/bench_probe). First the
    # SASS of the port-flag build: probe_dot_i8's kernels must hold integer
    # tensor-core instructions (IMMA, mma.sync's opcode).
    lib_path = _build.build_dir() / "libprobe.so"
    try:
        imma = BP.tensor_core_counts(lib_path)
    except (RuntimeError, OSError) as e:
        fail(f"probe_dot_i8 SASS: {e}")
    imma = {fn.rsplit("probe_dot_i8_kernel", 1)[1]: c for fn, c in imma.items()}
    if not all(imma.values()):
        fail(f"probe_dot_i8: a kernel without IMMA instructions in {lib_path}: {imma}")
    log(f"debug: probe_dot_i8 SASS (cuobjdump -sass): IMMA instructions in each of its "
        f"{len(imma)} instantiations {json.dumps(imma)}")

    # probe_dot_i8 against its plain version, torch._int_mm and numpy's
    # exact product (float64 BLAS: every sum is an integer below 2^53).
    dots = BP.dot_inputs(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    dots["odd [77,40]x[40,24] random"] = tuple(
        torch.randint(-128, 128, shp, generator=g, device=dev, dtype=torch.int32).to(torch.int8)
        for shp in ((77, 40), (40, 24)))
    for label, (qa, qb) in dots.items():
        got = PBK.probe_dot_i8(qa, qb)
        want = PBK.probe_dot_i8_plain(qa, qb)
        np_want = (qa.cpu().numpy().astype(np.float64) @ qb.cpu().numpy().astype(np.float64))
        same = {"plain": torch.equal(got, want), "torch._int_mm": torch.equal(
            got, torch._int_mm(qa, qb)), "numpy": bool(np.array_equal(
                got.cpu().numpy(), np_want.astype(np.int32)))}
        if not all(same.values()):
            fail(f"probe_dot_i8 {label}: equal to {same}")
        log(f"debug: probe_dot_i8 {label}: equal to its plain version, torch._int_mm and the "
            f"numpy product (sums in [{int(want.min())}, {int(want.max())}])")
    qa, qb = dots[next(k for k in dots if k.startswith("zig-zag") and "one-hot" in k)]
    b_ms, b_by = BP.dot_bound(*qa.shape, qb.shape[1])
    rec["probe_dot_i8"]["large"] = dict(
        shape=f"[{qa.shape[0]},{qa.shape[1]}] x [{qb.shape[0]},{qb.shape[1]}] int8 (one-hot B)",
        ms=device_time(lambda: PBK.probe_dot_i8(qa, qb), 20),
        plain_ms=device_time(lambda: PBK.probe_dot_i8_plain(qa, qb), 2),
        library_ms=device_time(lambda: torch._int_mm(qa, qb), 20), bound_ms=b_ms, bound_by=b_by)
    del dots, qa, qb, got, want, np_want

    # probe_elementwise at [3,2160,3840] (x light levels in (0, 1], y in
    # [0.5, 2), z in [-1, 1)), at a start one element in (a misaligned,
    # contiguous view) and at n % 4 == 3: every op but cbrt bit-equal to
    # its plain version; div and cbrt timed at the full shape.
    xyb = [torch.rand(BP.XYB_SHAPE, generator=g, device=dev).clamp_min_(1e-6),
           torch.rand(BP.XYB_SHAPE, generator=g, device=dev) * 1.5 + 0.5,
           torch.rand(BP.XYB_SHAPE, generator=g, device=dev) * 2 - 1]
    views = {"[3,2160,3840]": xyb, "one element in": [t.view(-1)[1:] for t in xyb],
             "n % 4 == 3": [t.view(-1)[:(1 << 19) + 3] for t in xyb]}
    for label, ins in views.items():
        bad = {}
        for op in PO.EQUAL_ON_CARD:
            n_in = PBK.OPS[op][1]
            got = PBK.probe_elementwise(op, *ins[:n_in])
            want = PBK.probe_elementwise_plain(op, *ins[:n_in])
            diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            if diff:
                bad[op] = diff
        if bad:
            fail(f"probe_elementwise {label}: values differing from the plain version {bad}")
        log(f"debug: probe_elementwise {label} ({ins[0].numel()} values, data_ptr % 16 = "
            f"{ins[0].data_ptr() % 16}): {', '.join(PO.EQUAL_ON_CARD)} bit-equal to their "
            f"plain versions")
    large = {}
    for op, lib_fn in (("div", torch.div), ("cbrt", None)):
        ins = xyb[:PBK.OPS[op][1]]
        b_ms, b_by = BP.elementwise_bound(ins[0].numel(), len(ins))
        large[op] = dict(
            shape=f"{op} {list(BP.XYB_SHAPE)} f32",
            ms=device_time(lambda: PBK.probe_elementwise(op, *ins), 20),
            plain_ms=device_time(lambda: PBK.probe_elementwise_plain(op, *ins), 20),
            library_ms=device_time(lambda: lib_fn(*ins), 20) if lib_fn else None,
            bound_ms=b_ms, bound_by=b_by)
    rec["probe_elementwise"]["large"] = large["div"]
    rec["probe_elementwise"]["large_cbrt"] = large["cbrt"]
    del xyb, views, ins
    for k, key in (("probe_dot_i8", "large"), ("probe_elementwise", "large"),
                   ("probe_elementwise", "large_cbrt")):
        r = rec[k][key]
        lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        log(f"  {k} {r['shape']}: kernel {r['ms']:.5f} ms ({r['bound_ms'] / r['ms']:.1%} of "
            f"its bound), plain {r['plain_ms']:.5f} ms, library {lib_ms}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}) [{card}]")

    # (c) With --trace-out, the Chrome trace of encode_report(photo8mp,
    # repeats=1) lands there (gzipped); phase 4 printed its report.
    if trace_out is not None:
        os.makedirs(trace_out, exist_ok=True)
        with profile_trace(os.path.join(HERE, "build", "trace_photo8mp")) as d:
            data, _ = encode_report(img8, DIST, repeats=1)
        if data != data_k:
            fail("encode_report: photo8mp bytes differ from phase 4's encode")
        dst = os.path.join(trace_out, "trace_photo8mp.json.gz")
        with open(os.path.join(d, "trace.json"), "rb") as f, gzip.open(dst, "wb") as g:
            shutil.copyfileobj(f, g)
        log(f"debug: torch.profiler trace of encode_report(photo8mp, repeats=1): {dst} "
            f"({os.path.getsize(dst)} bytes gzipped)")
    log(f"debug: phase 8 took {time.time() - t_phase:.1f} s")


def configs_phase(img8, rec, card, dev, hold_calls, reset_counts, wrappers, expect_launches):
    """Phase 9: the panorama, the 64-tile batch and the distance sweep (see
    the module docstring)."""
    import torch

    from jxl_tiny_tpu_torch import encoder as TE
    from jxl_tiny_tpu_torch.common import ImageDim
    from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
    from jxl_tiny_tpu_torch.ops import programs as PR
    from jxl_tiny_tpu_torch.tools import kernel_check as KC
    from jxl_tiny_tpu_torch.utils import debug_mode
    from jxl_tiny_tpu_torch.utils.profiling import device_time

    t_phase = time.time()
    progs = ("analyze_batch_packed", "pack_batch_sections")
    photo8 = linear_to_srgb_u8(img8)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def counted(label, fn):
        """fn() with each kernel's launches (counts set to 0 just before,
        read just after) once a program; every program a replay of its
        captured graph."""
        runs, restore = KC.count_programs(TE, progs)
        before = PR.stats()
        reset_counts()
        try:
            out, wall = timed(fn)
        finally:
            restore()
        launches = {k: wr.launches for k, wr in wrappers.items()}
        expect_launches(label, launches, runs["analyze_batch_packed"],
                        runs["pack_batch_sections"])
        caps, reps = (PR.stats()[k] - before[k] for k in ("captures", "replays"))
        if caps or reps != runs["analyze_batch_packed"] + runs["pack_batch_sections"]:
            fail(f"{label}: {caps} captures and {reps} replays for programs {runs}")
        runs["replays"] = reps
        return out, wall, launches, runs

    def cleared(label):
        st = PR.stats()
        log(f"configs: {label}: {st['programs']} captured programs held {st['pool_bytes']} "
            f"pool bytes; cleared [{card}]")
        PR.clear_programs()

    def held(label, fn, want, launches, key, groups):
        """Every kernel call of fn() recorded, then held against its plain
        version and timed (CUDA events, 3 calls each) one kernel at a time,
        each kernel's recorded inputs freed before the next."""
        got, calls, _ = KC.recorded(fn)
        if got != want:
            fail(f"{label}: the recorded encode differs")
        n_groups = calls["aq_field"][0][0].shape[0]
        sec = [a[0].shape[0] for a in calls["copy_sections"]]
        if n_groups != groups or max(sec) != groups:
            fail(f"{label}: {n_groups} groups, copy_sections at {sec}, not {groups}")
        errs, ms = {}, {}
        for name in list(calls):
            h_ = hold_calls(label, {name: calls.pop(name)},
                            lambda fn_: device_time(fn_, 3))[name]
            torch.cuda.empty_cache()
            errs[name], ms[name] = h_["max_abs_err"], sum(h_["ms"])
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], h_["max_abs_err"])
            rec[name][key] = dict(ms=ms[name], launches=launches[name], calls=h_["calls"])
        log(f"configs: {label}: every kernel call equal to its plain version (max_abs_err "
            f"{json.dumps(errs)}); copy_sections at {sec} sections; ms of the encode's "
            f"launches of each kernel (CUDA events) "
            f"{json.dumps({k: round(v, 4) for k, v in ms.items()})} [{card}]")

    # (a) The 63 MP panorama, u8 sRGB, one image.
    pan8 = panorama(photo8)
    dim = ImageDim(pan8.shape[2], pan8.shape[1])
    label = f"panorama {pan8.shape[2]}x{pan8.shape[1]} u8"
    if (dim.num_groups, dim.num_dc_groups) != (960, 16):
        fail(f"{label}: {dim.num_groups} groups in {dim.num_dc_groups} DC groups")
    PR.clear_programs()  # the pools below are the panorama's alone
    for _ in range(2):  # warm: a first call, then the captures
        TE.encode_image_device(pan8, DIST)
    torch.cuda.reset_peak_memory_stats()
    pan, wall, launches, runs = counted(label, lambda: TE.encode_image_device(pan8, DIST))
    # A replay allocates nothing: its buffers stay reserved in the pools.
    peak, pools = torch.cuda.max_memory_allocated(), PR.stats()["pool_bytes"]
    cleared(label)  # before the recorded run, which keeps every kernel input alive
    held(label, lambda: TE.encode_image_device(pan8, DIST), pan, launches, "groups_960", 960)
    with PR.eager():
        if TE.encode_image_device(pan8, DIST, kernels=False) != pan:
            fail(f"{label}: the kernels' encode differs from the plain versions'")
    try:
        with debug_mode():
            dbg, t_dbg = timed(lambda: TE.encode_image_device(pan8, DIST))
    except (IndexError, FloatingPointError) as e:
        fail(f"{label} inside debug_mode(): {e}")
    if dbg != pan:
        fail(f"{label}: the encode inside debug_mode() differs")
    log(f"configs: {label} inside debug_mode() (NaN checks, checked kernels): bytes equal, "
        f"no NaN, no out-of-bounds access; wall {t_dbg:.3f} s [{card}]")
    mp = pan8.shape[1] * pan8.shape[2] / 1e6
    log(f"configs: {label} ({mp:.2f} MP, {dim.num_groups} groups in {dim.num_dc_groups} DC "
        f"groups): {len(pan)} bytes, equal to the plain versions' encode; wall {wall:.3f} s "
        f"({mp / wall:.2f} MP/s, after a first call and a capture); peak memory "
        f"{peak + pools} B (the replay's max_memory_allocated {peak} B plus its programs' "
        f"pools {pools} B); programs "
        f"{json.dumps(runs)}; launches {json.dumps(launches)} [{card}]")
    del pan8, pan
    torch.cuda.empty_cache()

    # (b) 64 tiles of 1024x1024, u8 sRGB, as one batch: 1,024 groups.
    batch = tiles(photo8)
    label = f"batch of {len(batch)} tiles {batch.shape[3]}x{batch.shape[2]} u8"
    singles = [TE.encode_image_device(t, DIST) for t in batch]
    for _ in range(2):  # warm: a first call, then the captures
        TE.encode_batch_device(batch, DIST)
    got, wall, launches, runs = counted(label, lambda: TE.encode_batch_device(batch, DIST))
    if got != singles:
        fail(f"{label}: bytes differ from the single encodes")
    cleared(label)
    held(label, lambda: TE.encode_batch_device(batch, DIST), singles, launches,
         "groups_1024", 1024)
    with PR.eager():
        if TE.encode_batch_device(batch, DIST, kernels=False) != singles:
            fail(f"{label}: the plain versions' batch differs from the single encodes")
    mp = batch.shape[0] * batch.shape[2] * batch.shape[3] / 1e6
    log(f"configs: {label} ({mp:.2f} MP, 1024 groups in {len(batch)} DC groups): "
        f"{sum(map(len, got))} bytes, each tile equal to its single encode and to the plain "
        f"versions' batch; wall {wall:.3f} s ({mp / wall:.2f} MP/s, a replay); "
        f"programs {json.dumps(runs)}; launches {json.dumps(launches)} [{card}]")
    del batch, singles, got
    torch.cuda.empty_cache()

    # (c) The distance sweep's other two points on photo8mp.
    for d in (0.5, 2.0):
        k = TE.encode_image_device(img8, d)
        if any(TE.encode_image_device(img8, d) != k for _ in range(2)):
            fail(f"photo8mp d={d}: the captured or replayed encode differs from the first "
                 f"call's")
        with PR.eager():
            if TE.encode_image_device(img8, d, kernels=False) != k:
                fail(f"photo8mp d={d}: the kernels' encode differs from the plain versions'")
        log(f"configs: photo8mp d={d}: {len(k)} bytes as a first call, a capture and a "
            f"replay, equal "
            f"to the plain versions' encode")
    cleared("photo8mp at d = 0.5 and 2.0")
    log(f"configs: phase 9 took {time.time() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
