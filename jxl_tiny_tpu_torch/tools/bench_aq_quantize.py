"""Time variants of csrc/aq.cu and csrc/quantize.cu on the calls 8 MP encodes
make.

    python -m jxl_tiny_tpu_torch.tools.bench_aq_quantize \\
        [--variant aq:NAME:STRIP_BLOCKS=8,MIN_CTAS=1 ...] \\
        [--variant quantize:NAME:WARPS=4 ...] \\
        [--source aq:NAME:path/to/another/aq.cu[:device-consts] ...] \\
        [--out result.json]

Encodes testdata/photo8mp.pfm at the default configuration (the strategy
search's real map: every valid cell in a 16x8 or 8x16 pair) and with fixed
8x8 blocks (an all-DCT8 map), and records the arguments of every aq_field
and quantize_cells call on the way. Then each build of the kernel's source
(the tree's own as `tree`, the same source with other values of its
`constexpr` tuning constants, or another source file, such as an earlier
version or a copy with a part left out) is held against the plain torch
version on every recorded call (the tree's builds must be exact; another
source's mismatches are reported) and timed in turns, one round after
another. A source given with `:device-consts` has the launchers of the
kernels before the strip / quad redesign, which took their constants and
natural-order tables as tensors on the card.

Shares its build and timing machinery with tools/bench_compact.py: device
times (CUDA events around back-to-back launches queued behind a spin
kernel), the card's name and power limit with every table. Needs a CUDA
card and nvcc.
"""
import argparse
import json
import os
import sys

import torch

from ..common import EncoderConfig
from ..encoder import encode_image_device
from ..io.pfm import read_pfm
from ..ops import _build
from ..ops import aq_kernel as AQ
from ..ops import pipeline as PL
from ..ops import quantize_kernel as QK
from .bench_compact import ROOT, build, card_line, device_time_ms

BIND = {"aq": AQ._bind, "quantize": QK._bind}
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def launch_tree(kernel, lib, args):
    """The tree's wrapper, on a given library with the tree's launchers."""
    keep = _build._libs.get(kernel)
    _build._libs[kernel] = lib
    try:
        return (AQ.aq_field if kernel == "aq" else QK.quantize_cells)(*args)
    finally:
        if keep is None:
            del _build._libs[kernel]
        else:
            _build._libs[kernel] = keep


class DeviceConstsLauncher:
    """What the wrappers did before the redesign: constants as a tensor on
    the card (made once a setting here, outside the timed launches)."""

    def __init__(self):
        self.consts = {}

    def __call__(self, kernel, lib, args):
        if kernel == "aq":
            xyb, distance = args
            key = ("aq", float(distance))
            if key not in self.consts:
                vec, color = AQ.aq_constants(distance)
                self.consts[key] = (torch.from_numpy(vec).to(xyb.device), color)
            kvec, color = self.consts[key]
            g = xyb.shape[0]
            outs = [torch.empty((g, 32, 32), dtype=torch.float32, device=xyb.device)
                    for _ in range(3)]
            rc = lib.aq_launch(xyb.data_ptr(), *(o.data_ptr() for o in outs),
                               kvec.data_ptr(), g, int(color), _build.stream_ptr(xyb))
            _build.check(rc, "aq_field")
            return tuple(outs)
        c8, cv, ch, strat, rqf, fx, fb, tables, scale, scale_dc, x_qm_mul = args
        key = ("quantize", float(scale), float(scale_dc), float(x_qm_mul))
        if key not in self.consts:
            k = QK.quant_scalars(scale, scale_dc, x_qm_mul)
            self.consts[key] = torch.tensor(
                [k["scale"], k["x_qm_mul"], *k["inv_factor"], k["cfl_b"], *k["bias"],
                 k["sc"]], dtype=torch.float32).to(c8.device)
        g, dev = c8.shape[0], c8.device
        outs = [torch.empty(shape, dtype=torch.int32, device=dev) for shape in
                ((g, 32, 32, 3, 128), (g, 3, 32, 32), (g, 3, 2, 32, 32), (g, 3, 32, 32))]
        rc = lib.quantize_launch(
            c8.data_ptr(), cv.data_ptr(), ch.data_ptr(), strat.data_ptr(),
            rqf.data_ptr(), fx.data_ptr(), fb.data_ptr(), tables.qm_tab.data_ptr(),
            tables.dqm_tab.data_ptr(), tables.thr_tab.data_ptr(),
            tables.order_tab.data_ptr(), *(o.data_ptr() for o in outs), g,
            self.consts[key].data_ptr(), _build.stream_ptr(c8))
        _build.check(rc, "quantize_cells")
        return tuple(outs)


def plain(kernel, args):
    if kernel == "aq":
        vec, color = AQ.aq_constants(args[1])
        return AQ.aq_field_plain(args[0], vec, color)
    return QK.quantize_cells_plain(*args)


def mismatches(got, want):
    bad = 0
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad += int((a != b).sum())
    return bad


def bound_ms(kernel, args):
    """Bytes each call must move (inputs once, outputs once) at the card's
    memory rate; the same count as chip_smoke.py's."""
    if kernel == "aq":
        g = args[0].shape[0]
        nbytes = args[0].numel() * 4 + 3 * g * 1024 * 4 + 29 * 4
    else:
        cells = args[0].shape[0] * 1024
        nbytes = args[0].numel() * 4 + 4 * cells * 4 + cells * 384 * 4 + cells * 12 * 4
    return nbytes / MEM_BYTES_PER_S * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="KERNEL:NAME:CONST=V,CONST=V of the tree's source")
    ap.add_argument("--source", action="append", default=[],
                    help="KERNEL:NAME:PATH[:device-consts] of another source")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_aq_quantize: needs a CUDA card")
    card = card_line()
    print(card)

    # libs[kernel][name] = (library, launcher, must be exact)
    libs = {}
    launch_device_consts = DeviceConstsLauncher()
    for kernel in ("aq", "quantize"):
        src = _build.CSRC / f"{kernel}.cu"
        libs[kernel] = {"tree": (build(f"{kernel}_tree", src, bind=BIND[kernel],
                                       sub="bench_aq_quantize"), launch_tree, True)}
    for v in a.variant:
        kernel, name, flags = v.split(":", 2)
        libs[kernel][name] = (
            build(f"{kernel}_{name}", _build.CSRC / f"{kernel}.cu", flags.split(","),
                  bind=BIND[kernel], sub="bench_aq_quantize"), launch_tree, True)
    for s in a.source:
        kernel, name, path, *abi = s.split(":")
        if abi not in ([], ["device-consts"]):
            sys.exit(f"--source {s}: unknown launcher kind {abi}")
        libs[kernel][name] = (
            build(f"{kernel}_{name}", path, bind=BIND[kernel], sub="bench_aq_quantize"),
            launch_device_consts if abi else launch_tree, False)

    # Record the calls of a default and a fixed-8x8 encode of photo8mp.
    calls = []
    real = AQ.aq_field, PL.quantize_cells

    def recorder(kernel, fn, label):
        def rec(*args):
            calls.append((kernel, label, args))
            return fn(*args)
        return rec

    img = read_pfm(os.path.join(ROOT, "testdata", "photo8mp.pfm"))
    try:
        for label, cfg in (("default", EncoderConfig()),
                           ("fixed 8x8", EncoderConfig(optimize_block_sizes=False))):
            AQ.aq_field = recorder("aq", real[0], label)
            PL.quantize_cells = recorder("quantize", real[1], label)
            size = len(encode_image_device(img, 1.0, config=cfg))
            print(f"photo8mp {label} encode: {size} bytes")
    finally:
        AQ.aq_field, PL.quantize_cells = real
    # The two encodes hand aq_field the same tensor: keep one.
    calls = [c for c in calls if not (c[0] == "aq" and c[1] == "fixed 8x8")]

    results = []
    for kernel, label, args in calls:
        want = plain(kernel, args)
        row = dict(kernel=kernel, call=label, bound_ms=round(bound_ms(kernel, args), 5),
                   mismatches={}, ms={})
        if kernel == "quantize":
            strat = args[3]
            row["cells_by_strategy"] = [int((strat == s).sum()) for s in range(3)]
        for name, (lib, launcher, exact) in libs[kernel].items():
            got = launcher(kernel, lib, args)
            torch.cuda.synchronize()
            bad = mismatches(got, want)
            if bad and exact:
                sys.exit(f"{kernel} ({label}): {name} differs from the plain "
                         f"version in {bad} elements")
            row["mismatches"][name] = bad
        del want
        times = {name: [] for name in libs[kernel]}
        for _ in range(a.rounds):
            for name, (lib, launcher, _) in libs[kernel].items():
                times[name].append(device_time_ms(
                    lambda: launcher(kernel, lib, args), a.reps))
        row["ms"] = {k: [round(x, 5) for x in v] for k, v in times.items()}
        results.append(row)
        print(f"{kernel} ({label}) G={args[0].shape[0]}"
              f"{' cells DCT8/16x8/8x16 ' + str(row['cells_by_strategy']) if kernel == 'quantize' else ''}"
              f": bound {row['bound_ms']} ms; elements that differ from the plain "
              f"version {row['mismatches']} [{card}]")
        for k, v in row["ms"].items():
            print(f"    {k:>16}: min {min(v):.5f} ms  rounds {v}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(card=card, results=results), f, indent=1)


if __name__ == "__main__":
    main()
