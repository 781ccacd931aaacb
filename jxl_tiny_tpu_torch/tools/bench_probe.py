"""Time builds of csrc/probe.cu (the exactness probe's two kernels) at the
probe's shapes and at photo8mp's.

    python -m jxl_tiny_tpu_torch.tools.bench_probe [--variant NAME:STAGES=4,EW_UNROLL=2 ...] \\
        [--source NAME:path/to/another/probe.cu ...] [--rounds 3] [--out result.json]

Shapes: `probe_dot_i8` at the probe's [256,128] x [128,128] one-hot pair and
at one permutation chunk of the JAX quantizer's int8 zig-zag over photo8mp
(G = 135 groups x 3 channels x 1,024 rows: [414720,128] x [128,128]; A
random full-range int8, B the probe's one-hot permutation and, again, random
full-range int8); `probe_elementwise` on div over the probe's 2^19 values
and on div and cbrt over [3,2160,3840] float32 (photo8mp's XYB planes).
Each build (the tree's as `tree`, the same source with other values of its
`constexpr` tuning constants, or another source with the same
launchers, such as an earlier version: `git show <commit>:jxl_tiny_tpu_torch/
csrc/probe.cu` into a gitignored directory) is held against the plain torch
version and timed in turns, one round after another, beside the plain
version and the one-call torch equivalent (`torch._int_mm`, `torch.div`;
cbrt's plain version, pow(x, 1/3), is itself one torch call). A launch the card refuses (the pre-tensor-core
kernel's grid of one block row per output row stops at 65,535 rows) is
reported with its error, and that build is then timed as launches over
slices of at most 65,535 rows. Prints each build's registers and shared
memory, the tensor-core instructions of its probe_dot_i8 kernels
(cuobjdump -sass) and the card's name and power limit with every table.
Needs a CUDA card and nvcc.
"""
import argparse
import json
import os
import sys

import torch

from ..ops import _build
from ..ops import probe_kernels as PBK
from ..utils.profiling import device_time
from . import bench_compact as BC
from . import bench_strategy_bitpack as BS
from . import probe_op_exactness as PO

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
ZIGZAG_ROWS = 135 * 3 * 1024  # photo8mp's groups x channels x rows of a channel tile
XYB_SHAPE = (3, 2160, 3840)
MAX_GRID_Y = 65535


def dot_bound(m, k, n):
    """(ms, "bytes" | "operations"): A and B read once, the int32 output
    written once; 2 M K N operations at the int8 tensor-core rate."""
    t_b = (m * k + k * n + 4 * m * n) / MEM_BYTES_PER_S * 1e3
    t_o = 2 * m * k * n / INT8_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def elementwise_bound(n, n_inputs):
    """(ms, "bytes" | "operations") of one float op over n values."""
    t_b = (n_inputs + 1) * n * 4 / MEM_BYTES_PER_S * 1e3
    t_o = n / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def tensor_core_counts(lib_path):
    """{probe_dot_i8 kernel (mangled name): integer matrix instructions
    (IMMA) in its SASS}, from the toolkit's own cuobjdump (beside nvcc).
    Raises when cuobjdump is missing or the library holds no such kernel."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found at {tool}: cannot read the SASS")
    counts = {fn: mix.get("IMMA", 0) for fn, mix in BS.sass_mix(lib_path).items()
              if "probe_dot_i8_kernel" in fn}
    if not counts:
        raise RuntimeError(f"no probe_dot_i8 kernel in the SASS of {lib_path}")
    return counts


def dot_inputs(dev, seed=0):
    """{label: (a, b)}: the probe's pair and the zig-zag chunk (one-hot and
    random B) on the card."""
    _, _, _, q, perm = PO.probe_inputs(19)
    g = torch.Generator(device=dev).manual_seed(seed)
    big = torch.randint(-128, 128, (ZIGZAG_ROWS, 128), generator=g, device=dev,
                        dtype=torch.int32).to(torch.int8)
    full_b = torch.randint(-128, 128, (128, 128), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
    one_hot = torch.from_numpy(perm).to(dev)
    return {
        "probe [256,128]x[128,128] one-hot": (torch.from_numpy(q).to(dev), one_hot),
        f"zig-zag [{ZIGZAG_ROWS},128]x[128,128] one-hot": (big, one_hot),
        f"zig-zag [{ZIGZAG_ROWS},128]x[128,128] random B": (big, full_b),
    }


def elementwise_inputs(dev, seed=0):
    """{label: (op, inputs)}: div over the probe's 2^19 values, div and cbrt
    over [3,2160,3840] (x in (0, 1], as light levels; y in [0.5, 2))."""
    x, y, _, _, _ = PO.probe_inputs(19)
    g = torch.Generator(device=dev).manual_seed(seed)
    bx = torch.rand(XYB_SHAPE, generator=g, device=dev).clamp_min_(1e-6)
    by = torch.rand(XYB_SHAPE, generator=g, device=dev) * 1.5 + 0.5
    return {
        "div [512,1024]": ("div", (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))),
        "div [3,2160,3840]": ("div", (bx, by)),
        "cbrt [3,2160,3840]": ("cbrt", (bx,)),
    }


def launch_dot(lib, a, b):
    """What the wrapper does, on a given library; (out, error code of a
    refused single launch or 0). A refused launch is made again over slices
    of at most MAX_GRID_Y rows."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    stream = _build.stream_ptr(a)
    rc = lib.probe_dot_i8(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, stream)
    if rc == 0:
        return out, 0
    for r in range(0, m, MAX_GRID_Y):
        rows = min(MAX_GRID_Y, m - r)
        _build.check(lib.probe_dot_i8(a[r:].data_ptr(), b.data_ptr(), out[r:].data_ptr(),
                                      rows, k, n, stream), "probe_dot_i8 (row slices)")
    return out, rc


def launch_elementwise(lib, op, ins):
    code, _ = PBK.OPS[op]
    ptrs = [t.data_ptr() for t in ins] + [ins[0].data_ptr()] * (3 - len(ins))
    out = torch.empty_like(ins[0])
    _build.check(lib.probe_elementwise(*ptrs, out.data_ptr(), ins[0].numel(), code,
                                       _build.stream_ptr(ins[0])), f"probe_elementwise {op}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=V,CONST=V of the tree's probe.cu")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME:PATH of another probe.cu with the same launchers")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_probe: needs a CUDA card")
    card = BC.card_line()
    print(card)
    dev = torch.device("cuda")
    tree_src = _build.CSRC / "probe.cu"
    libs = {"tree": BC.build("tree", tree_src, bind=PBK._bind, sub="bench_probe")}
    for v in a.variant:
        name, consts = v.split(":", 1)
        libs[name] = BC.build(name, tree_src, consts.split(","), bind=PBK._bind,
                              sub="bench_probe")
    for v in a.source:
        name, path = v.split(":", 1)
        libs[name] = BC.build(name, path, bind=PBK._bind, sub="bench_probe")
    for name in libs:
        lib_path = _build.BUILD_ROOT / "bench_probe" / f"lib{name}.so"
        print(f"sass {name}: IMMA in probe_dot_i8 kernels "
              f"{json.dumps(tensor_core_counts(lib_path))}")

    sources = {v.split(":", 1)[0] for v in a.source}
    results = []
    for label, (qa, qb) in dot_inputs(dev).items():
        want = PBK.probe_dot_i8_plain(qa, qb)
        if not torch.equal(torch._int_mm(qa, qb), want):
            sys.exit(f"{label}: torch._int_mm computes something else")
        row = dict(kernel="probe_dot_i8", what=label, refused={}, mismatches={})
        for name, lib in libs.items():
            got, rc = launch_dot(lib, qa, qb)
            torch.cuda.synchronize()
            row["refused"][name] = rc
            row["mismatches"][name] = int((got != want).sum())
        if any(row["mismatches"][name] for name in libs if name not in sources):
            sys.exit(f"{label}: a build of the tree's kernel differs from the plain version "
                     f"{row['mismatches']}")
        fns = {name: (lambda lib=lib: launch_dot(lib, qa, qb)) for name, lib in libs.items()}
        fns["plain"] = lambda: PBK.probe_dot_i8_plain(qa, qb)
        fns["torch._int_mm"] = lambda: torch._int_mm(qa, qb)
        row["bound_ms"], row["bound_by"] = dot_bound(qa.shape[0], qa.shape[1], qb.shape[1])
        results.append(_timed(row, fns, a, card))

    for label, (op, ins) in elementwise_inputs(dev).items():
        want = PBK.probe_elementwise_plain(op, *ins)
        row = dict(kernel="probe_elementwise", what=label, mismatches={})
        for name, lib in libs.items():
            got = launch_elementwise(lib, op, ins)
            row["mismatches"][name] = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if op == "div" and any(row["mismatches"][name] for name in libs if name not in sources):
            sys.exit(f"{label}: a build of the tree's kernel differs from torch's division "
                     f"{row['mismatches']}")
        fns = {name: (lambda lib=lib: launch_elementwise(lib, op, ins))
               for name, lib in libs.items()}
        fns["plain"] = lambda: PBK.probe_elementwise_plain(op, *ins)
        if op == "div":
            fns["torch.div"] = lambda: torch.div(*ins)
        row["bound_ms"], row["bound_by"] = elementwise_bound(ins[0].numel(), len(ins))
        results.append(_timed(row, fns, a, card))

    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(card=card, results=results), f, indent=1)


def _timed(row, fns, a, card):
    """Time every fn in turns, `rounds` rounds; print the row."""
    times = {k: [] for k in fns}
    reps = a.reps if row["bound_ms"] > 0.01 else 5 * a.reps
    for _ in range(a.rounds):
        for k, fn in fns.items():
            times[k].append(device_time(fn, reps if k != "plain" else max(1, reps // 10)))
    row["ms"] = times
    print(f"{row['kernel']} {row['what']}: bound {row['bound_ms']:.6f} ms ({row['bound_by']}); "
          f"refused launches {row.get('refused', {})}, elements differing from the plain "
          f"version {row['mismatches']} [{card}]")
    for k, v in times.items():
        share = row["bound_ms"] / min(v)
        print(f"    {k:>16}: min {min(v):.5f} ms ({share:.1%} of bound)  rounds "
              f"{[round(x, 5) for x in v]}")
    return row


if __name__ == "__main__":
    main()
