"""Time variants of csrc/compact.cu on the calls one 8 MP encode makes.

    python -m jxl_tiny_tpu_torch.tools.bench_compact \\
        [--variant NAME:NV=1,THREADS=256 ...] \\
        [--source NAME:path/to/another/compact.cu ...] [--out result.json]

Encodes testdata/photo8mp.pfm once at the default configuration and records
the arguments of every compact_rows and copy_sections call on the way
(program A's tokens, program B's AC and DC word rows at each `ow` it is
dispatched with, the AC and DC sections). Then each build of compact.cu
(the tree's own as `tree`, the same source with other values of its
`constexpr` tuning constants, or another source file with the same
launchers, such as an earlier version) is held
against the plain torch version on every recorded call (the tree's builds
must be exact; another source's mismatches are reported) and timed
in turns, one round after another, beside the one-call torch equivalent:
`zero_()` + `index_put_` on a preallocated buffer with precomputed indices.

Times are device times: CUDA events around `reps` back-to-back launches
that are queued behind a spin kernel, so that the host's call overhead
(tens of microseconds, more than these kernels take) stays out of them.
Prints the card's name and power limit with every table. Needs a CUDA
card and nvcc.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from ..encoder import encode_image_device
from ..io.pfm import read_pfm
from ..ops import _build
from ..ops import pack_kernels as PK

W = PK.W
ROOT = _build.CSRC.parents[1]


def build(name, source, consts=(), bind=PK._bind_compact, sub="bench_compact"):
    """nvcc one kernel source into a library of its own (under the build
    directory's `sub`); `consts` are NAME=VALUE replacements for the
    source's `constexpr int|bool NAME = ...;` lines, `bind` sets the
    launchers' argument types. Prints each kernel's registers and shared
    memory."""
    out_dir = _build.BUILD_ROOT / sub
    out_dir.mkdir(parents=True, exist_ok=True)
    text = open(source).read()
    for c in consts:
        key, value = c.split("=", 1)
        text, hits = re.subn(rf"(constexpr (?:int|bool) {key} = )[^;]+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            sys.exit(f"{name}: no constant {key} in {source}")
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas", "-v",
           "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"{name}: nvcc failed:\n{res.stdout}{res.stderr}")
    for line in res.stderr.splitlines():
        if "registers" in line:
            print(f"  [{name}] {line.strip()}")
    handle = ctypes.CDLL(str(lib))
    bind(handle)
    return handle


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def launch(lib, kind, args):
    """What the wrappers do, on a given library."""
    if kind == "compact_rows":
        tok, cnt, start, cap = args
        g, r, _ = tok.shape
        out = torch.empty((g, cap + W), dtype=torch.int32, device=tok.device)
        rc = lib.compact_rows_launch(tok.data_ptr(), cnt.data_ptr(), start.data_ptr(),
                                     out.data_ptr(), g, r, cap, _build.stream_ptr(tok))
    else:
        packed, nblk, offs, wcap = args
        g, ow = packed.shape
        out = torch.empty((wcap,), dtype=torch.int32, device=packed.device)
        rc = lib.copy_sections_launch(packed.data_ptr(), nblk.data_ptr(), offs.data_ptr(),
                                      out.data_ptr(), g, ow, wcap, _build.stream_ptr(packed))
    _build.check(rc, kind)
    return out


def device_time_ms(fn, reps, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(3_000_000)  # ~1.5 ms: the host queues every launch meanwhile
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library_pair(kind, args):
    """zero_() + index_put_ computing the same function; returns (fn, its
    buffer, the number of words it places)."""
    if kind == "compact_rows":
        tok, cnt, start, cap = args
        g = tok.shape[0]
        lane = torch.arange(W, device=tok.device)
        pos = start[..., None] + lane
        m = (lane < cnt[..., None]) & (pos < cap)
        gi = torch.arange(g, device=tok.device)[:, None, None].expand_as(pos)
        idx, vals = (gi[m], pos[m]), tok[m]
        buf = torch.empty((g, cap + W), dtype=torch.int32, device=tok.device)
    else:
        packed, nblk, offs, wcap = args
        wi = torch.arange(packed.shape[1], device=packed.device)[None, :]
        dst = offs[:, None] + wi
        m = (wi < nblk[:, None] * W) & (dst < wcap)
        idx, vals = (dst[m],), packed[m]
        buf = torch.empty((wcap,), dtype=torch.int32, device=packed.device)
    return (lambda: buf.zero_().index_put_(idx, vals)), buf, int(vals.numel())


def describe(kind, args):
    if kind == "compact_rows":
        tok, cnt, _, cap = args
        return (f"compact_rows tok{list(tok.shape)} cap {cap}, "
                f"{int(cnt.sum())} words, {int((cnt == 0).sum())} empty rows")
    packed, nblk, _, wcap = args
    return (f"copy_sections packed{list(packed.shape)} wcap {wcap}, "
            f"{int(nblk.sum())} blocks")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=V,CONST=V of the tree's compact.cu")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME:PATH of another compact.cu with the same launchers")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_compact: needs a CUDA card")
    card = card_line()
    print(card)

    tree_src = _build.CSRC / "compact.cu"
    libs = {"tree": build("tree", tree_src)}
    variants = [v.split(":", 1) for v in a.variant]
    for name, flags in variants:
        libs[name] = build(name, tree_src, flags.split(","))
    variants = {name for name, _ in variants}
    for s in a.source:
        name, path = s.split(":", 1)
        libs[name] = build(name, path)

    # Record the calls of one default 8 MP encode.
    calls = []
    real = PK.compact_rows, PK.copy_sections

    def recorder(kind, fn):
        def rec(*args):
            calls.append((kind, args))
            return fn(*args)
        return rec

    PK.compact_rows = recorder("compact_rows", real[0])
    PK.copy_sections = recorder("copy_sections", real[1])
    try:
        img = read_pfm(os.path.join(ROOT, "testdata", "photo8mp.pfm"))
        size = len(encode_image_device(img, 1.0))
    finally:
        PK.compact_rows, PK.copy_sections = real
    print(f"photo8mp default encode: {size} bytes, {len(calls)} recorded calls")

    results = []
    for n, (kind, args) in enumerate(calls):
        want = (PK.compact_rows_plain if kind == "compact_rows"
                else PK.copy_sections_plain)(*args)
        lib_fn, lib_buf, nvals = library_pair(kind, args)
        lib_fn()
        if not torch.equal(lib_buf, want):
            sys.exit(f"call {n}: the library pair computes something else")
        row = dict(call=n, what=describe(kind, args), ms={})
        for name, lib in libs.items():
            got = launch(lib, kind, args)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            if bad and (name == "tree" or name in variants):
                sys.exit(f"call {n} {row['what']}: variant {name} differs from "
                         f"the plain version in {bad} words")
            row.setdefault("mismatches", {})[name] = bad
        times = {name: [] for name in (*libs, "zero_+index_put_")}
        for _ in range(a.rounds):
            for name, lib in libs.items():
                times[name].append(device_time_ms(
                    lambda: launch(lib, kind, args), a.reps))
            times["zero_+index_put_"].append(device_time_ms(lib_fn, a.reps))
        row["ms"] = {k: [round(x, 5) for x in v] for k, v in times.items()}
        out_words = want.numel()
        nbytes = out_words * 4 + nvals * 4 + (
            args[1].numel() * 12 if kind == "compact_rows" else args[0].shape[0] * 16)
        row["bound_ms"] = round(nbytes / 3.35e12 * 1e3, 5)
        results.append(row)
        print(f"call {n}: {row['what']}; bound {row['bound_ms']} ms; words that "
              f"differ from the plain version {row['mismatches']} [{card}]")
        for k, v in row["ms"].items():
            print(f"    {k:>20}: min {min(v):.5f} ms  rounds {v}")
    names = list(results[0]["ms"])
    sums = {k: round(sum(min(r["ms"][k]) for r in results), 5) for k in names}
    print(f"sum over the encode's {len(results)} calls (min of rounds each): {sums} "
          f"ms [{card}]")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(card=card, results=results, sums=sums), f, indent=1)


if __name__ == "__main__":
    main()
