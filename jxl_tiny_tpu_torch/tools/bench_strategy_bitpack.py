"""Time variants of csrc/strategy.cu and csrc/bitpack.cu on the calls of an
8 MP encode.

    python -m jxl_tiny_tpu_torch.tools.bench_strategy_bitpack \\
        [--variant strategy:NAME:CTAS_PER_SM=2,FAST_SQRT=false ...] \\
        [--variant bitpack:NAME:RUN=4 ...] \\
        [--source strategy:NAME:path/to/another/strategy.cu ...] \\
        [--source bitpack:NAME:path/to/another/bitpack.cu[:int64] ...] \\
        [--sass] [--out result.json]

Encodes testdata/photo8mp.pfm once at the default configuration and
records the arguments of its estimate_partials call and of both program B
word packings (the AC tokens, and the DC layout's tokens, whose zero widths
interleave, at every `ow` the encode dispatches them with). The packings
are handed to bitpack_groups_var, which no encode calls, as int32 fields.
Then each build of a kernel's source (the tree's own as `tree`, the same
source with other values of its `constexpr` tuning constants, or another
source file, such as an earlier version or a copy with a part left out) is
held against the plain torch version on every recorded call (the tree's
builds must be exact; another source's mismatches are reported) and timed
in turns, one round after another. A bitpack source given with `:int64`
has the launcher from before the int32 redesign, which took int64 fields
(converted once, outside the timed launches). `--sass` prints each build's
instruction mix (cuobjdump -sass, static counts by opcode).

Shares its build and timing machinery with tools/bench_compact.py: device
times (CUDA events around back-to-back launches queued behind a spin
kernel), the card's name and power limit with every table. Needs a CUDA
card and nvcc.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

import torch

from ..encoder import encode_image_device
from ..io.pfm import read_pfm
from ..ops import _build
from ..ops import dc_kernels as DK
from ..ops import pack_kernels as PK
from ..ops import pipeline as PL
from ..ops import strategy_kernel as SK
from .bench_compact import ROOT, build, card_line, device_time_ms

BIND = {"strategy": SK._bind, "bitpack": PK._bind_bitpack}
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def launch(kernel, lib, args, int64=False):
    """What the wrappers do, on a given library."""
    if kernel == "strategy":
        *tensors, slope = args
        g, dev = tensors[0].shape[0], tensors[0].device
        outs = tuple(torch.empty((g, 3, 2, r, c), dtype=torch.float32, device=dev)
                     for r, c in ((32, 32), (16, 32), (32, 16)))
        rc = lib.strategy_launch(*(a.data_ptr() for a in tensors),
                                 *(o.data_ptr() for o in outs), g,
                                 float(SK.nz_cost(slope)), _build.stream_ptr(tensors[0]))
        _build.check(rc, "estimate_partials")
        return outs
    fields, ow = (args["int64"] if int64 else args["int32"]), args["ow"]
    g, cap = fields[0].shape
    out = torch.empty((g, ow), dtype=torch.int32, device=fields[0].device)
    rc = lib.bitpack_launch(*(f.data_ptr() for f in fields), out.data_ptr(), g, cap, ow,
                            _build.stream_ptr(out))
    _build.check(rc, "bitpack_groups_var")
    return (out,)


def plain(kernel, args):
    if kernel == "strategy":
        return SK.estimate_partials_plain(*args)
    return (PK.bitpack_groups_var_plain(*args["int32"], args["ow"]),)


def mismatches(got, want):
    bad = 0
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad += int((a != b).sum())
    return bad


def bound_ms(kernel, args):
    """Bytes each call must move at the card's memory rate (the count
    chip_smoke.py uses): estimate_partials reads its inputs once and writes
    its outputs once; bitpack_groups_var reads data and width of each token
    up to a group's last token of nonzero width (the positions follow from
    the widths) and writes every word once."""
    if kernel == "strategy":
        tensors = args[:-1]
        g = tensors[0].shape[0]
        nbytes = sum(a.numel() * 4 for a in tensors) + g * 6 * 2048 * 4
    else:
        nbytes = var_needed_bytes(args["int32"][1], args["ow"])
    return nbytes / MEM_BYTES_PER_S * 1e3


def var_needed_bytes(nbits, ow):
    """data + width (4 B each) of every token up to a group's last token of
    nonzero width, and the [G, ow] words written once: the positions follow
    from the widths (one a run of tokens is read), and past a section's
    last token only the zero words are needed."""
    g, cap = nbits.shape
    idx = torch.arange(1, cap + 1, device=nbits.device)
    needed = int(torch.where(nbits > 0, idx, 0).amax(dim=1).sum())
    return needed * 8 + g * ow * 4


def sass_mix(lib_path):
    """Static instruction counts by opcode of each kernel in a library."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    mix, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and fn:
            mix[fn][m.group(1)] += 1
    return mix


def record_calls():
    """The estimate_partials call and the word packings of one default 8 MP
    encode, as (kernel, label, args)."""
    calls = []
    real = PL.estimate_partials, PK.bitpack_groups_words, DK.bitpack_groups_words

    def rec_estimate(*args):
        calls.append(("strategy", "default encode", args))
        return real[0](*args)

    def rec_words(which, fn):
        def rec(data, nbits, pos, ow, prefix_valid=True, kernels=True):
            fields64 = tuple(t.contiguous() for t in (data, nbits, pos))
            label = f"{which} tokens {list(data.shape)}, ow {ow}"
            if not any(c[1] == label for c in calls):
                calls.append(("bitpack", label, dict(
                    ow=ow, int64=fields64,
                    int32=tuple(t.to(torch.int32) for t in fields64))))
            return fn(data, nbits, pos, ow, prefix_valid=prefix_valid, kernels=kernels)
        return rec

    PL.estimate_partials = rec_estimate
    PK.bitpack_groups_words = rec_words("AC", real[1])
    DK.bitpack_groups_words = rec_words("DC", real[2])
    try:
        img = read_pfm(os.path.join(ROOT, "testdata", "photo8mp.pfm"))
        size = len(encode_image_device(img, 1.0))
    finally:
        PL.estimate_partials, PK.bitpack_groups_words, DK.bitpack_groups_words = real
    print(f"photo8mp default encode: {size} bytes, {len(calls)} recorded calls")
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="KERNEL:NAME:CONST=V,CONST=V of the tree's source")
    ap.add_argument("--source", action="append", default=[],
                    help="KERNEL:NAME:PATH[:int64] of another source")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_strategy_bitpack: needs a CUDA card")
    card = card_line()
    print(card)

    # libs[kernel][name] = (library, int64 launcher, must be exact)
    libs, builds = {}, []
    sub = "bench_strategy_bitpack"
    for kernel in ("strategy", "bitpack"):
        src = _build.CSRC / f"{kernel}.cu"
        libs[kernel] = {"tree": (build(f"{kernel}_tree", src, bind=BIND[kernel], sub=sub),
                                 False, True)}
        builds.append((kernel, "tree"))
    for v in a.variant:
        kernel, name, flags = v.split(":", 2)
        libs[kernel][name] = (build(f"{kernel}_{name}", _build.CSRC / f"{kernel}.cu",
                                    flags.split(","), bind=BIND[kernel], sub=sub), False, True)
        builds.append((kernel, name))
    for s in a.source:
        kernel, name, path, *abi = s.split(":")
        if abi not in ([], ["int64"]) or (abi and kernel != "bitpack"):
            sys.exit(f"--source {s}: unknown launcher kind {abi}")
        libs[kernel][name] = (build(f"{kernel}_{name}", path, bind=BIND[kernel], sub=sub),
                              bool(abi), False)
        builds.append((kernel, name))
    if a.sass:
        for kernel, name in builds:
            path = _build.BUILD_ROOT / sub / f"lib{kernel}_{name}.so"
            for fn, mix in sass_mix(path).items():
                print(f"sass {kernel}:{name} {fn}: {sum(mix.values())} instructions; "
                      f"{dict(mix.most_common())}")

    results = []
    for kernel, label, args in record_calls():
        want = plain(kernel, args)
        row = dict(kernel=kernel, call=label, bound_ms=round(bound_ms(kernel, args), 5),
                   mismatches={}, ms={})
        for name, (lib, int64, exact) in libs[kernel].items():
            got = launch(kernel, lib, args, int64)
            torch.cuda.synchronize()
            bad = mismatches(got, want)
            if bad and exact:
                sys.exit(f"{kernel} ({label}): {name} differs from the plain "
                         f"version in {bad} elements")
            row["mismatches"][name] = bad
        del want
        times = {name: [] for name in libs[kernel]}
        for _ in range(a.rounds):
            for name, (lib, int64, _) in libs[kernel].items():
                times[name].append(device_time_ms(
                    lambda: launch(kernel, lib, args, int64), a.reps))
        row["ms"] = {k: [round(x, 5) for x in v] for k, v in times.items()}
        results.append(row)
        print(f"{kernel} ({label}): bound {row['bound_ms']} ms; elements that differ "
              f"from the plain version {row['mismatches']} [{card}]")
        for k, v in row["ms"].items():
            print(f"    {k:>16}: min {min(v):.5f} ms  rounds {v}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(card=card, results=results), f, indent=1)


if __name__ == "__main__":
    main()
