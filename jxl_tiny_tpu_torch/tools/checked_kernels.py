"""The checked build of the encode's kernels (ops/_build.CHECKED_FLAGS,
csrc/check.cuh) held on the card: what chip_smoke.py's phase 8 and the
`gpu` tests of tests/test_torch_debug_checked.py share.

- `ptxas_report`: registers and spill bytes of each source's kernels at two
  flag sets (nvcc -cubin -Xptxas -v, every compile started together);
- `small_calls`: one real call of each of the seven checked kernels, at
  gradient512's shapes (its encode's recorded calls; bitpack_groups_var on
  seeded token fields);
- `hold_checked`: a call through the normal build, the checked build (inside
  debug_mode) and the plain version, exactly; with a timer, the normal and
  the checked build's device times;
- `deferred_faults`: checked launches without the read-back after each one
  (for timing), the fault records read once at the end;
- `inject`: one fault a kernel, made by calling its checked launcher
  directly with the extent of one output cut one element short and a
  canary tail after the cut: the fault must name the kernel and a guard of
  that buffer, the canary must be untouched, and the next normal launch
  must still equal the plain version.

Needs a CUDA card and nvcc.
"""
import contextlib
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import aq_kernel as AQ
from ..ops import pack_kernels as PK
from ..ops import quantize_kernel as QK
from ..ops import strategy_kernel as SK
from ..ops import tokenize_kernel as TK
from ..utils.debug import debug_mode
from . import kernel_check as KC

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"
# The buffer each injected fault cuts (its position among the launcher's
# pointers) and that buffer's extent as the source's guards name it.
INJECT = {
    "aq_field": (3, "n_mask"),
    "estimate_partials": (16, "n.out"),
    "quantize_cells": (14, "X.lastnz"),
    "tokenize_rows": (3, "n_out"),
    "compact_rows": (3, "n_stream"),
    "copy_sections": (3, "n_buf"),
    "bitpack_groups_var": (3, "n_out"),
}
CANARY = 64  # elements of the tail after the cut
SENTINEL = 0x5A5A5A5A


def covered_kernels():
    """({name: wrapper}, {name: plain version}) of the seven kernels the
    checked build covers: the encode's six and bitpack_groups_var."""
    wrappers, plain = KC.on_path_kernels()
    wrappers["bitpack_groups_var"] = PK.bitpack_groups_var
    plain["bitpack_groups_var"] = PK.bitpack_groups_var_plain
    return wrappers, plain


def ptxas_report(flag_sets, names=_build.CHECKED_SOURCES):
    """{source: {label: dict(registers: the most of its kernels, spill_bytes:
    stores + loads summed over them, kernels)}} for each flag set of
    flag_sets {label: nvcc flags}, from nvcc -cubin -Xptxas -v."""
    out_dir = _build.BUILD_ROOT / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    drop = {"-shared", "-Xcompiler", "-fPIC"}

    def one(label, flags, name):
        cmd = [_build._nvcc(), *(f for f in flags if f not in drop), "-cubin", "-Xptxas", "-v",
               "-I", str(_build.CSRC), "-o", str(out_dir / f"{name}_{label}.cubin"),
               str(_build.CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc -cubin {name} ({label}):\n{res.stdout}{res.stderr}")
        regs, spill = [], 0
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill += int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
        return name, label, dict(registers=max(regs, default=0), spill_bytes=spill,
                                 kernels=len(regs))

    jobs = [(label, flags, name) for label, flags in flag_sets.items() for name in names]
    report = {name: {} for name in names}
    with ThreadPoolExecutor(len(jobs)) as pool:
        for name, label, rec in pool.map(lambda j: one(*j), jobs):
            report[name][label] = rec
    return report


def bitpack_fields(dev, groups=3, cap=4096, seed=11):
    """Token fields of bitpack_groups_var (int32 data, widths 0-28, positions
    the exclusive prefix sum of the widths) and an ow that holds them."""
    rng = np.random.RandomState(seed)
    nbits = rng.randint(0, 29, size=(groups, cap)).astype(np.int64)
    nbits[:, cap - cap // 4:] = 0  # a tail of empty tokens
    data = rng.randint(0, 1 << 28, size=(groups, cap)).astype(np.int64) & ((1 << nbits) - 1)
    pos = np.cumsum(nbits, axis=1) - nbits
    ow = -(-int((pos[:, -1] + nbits[:, -1]).max() + 31) // 32 // 128) * 128
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (data, nbits, pos)) + (ow,)


def small_calls(dev):
    """{kernel: [args]}: every call gradient512's default encode makes of
    the six encode kernels (recorded), and bitpack_groups_var on seeded
    fields."""
    from ..encoder import encode_image_device
    from ..io.pfm import read_pfm

    img = read_pfm(str(TESTDATA / "gradient512.pfm"))
    _, calls, _ = KC.recorded(lambda: encode_image_device(img, 1.0, device=dev))
    calls["bitpack_groups_var"] = [bitpack_fields(dev)]
    return calls


def _outputs(x):
    return list(x) if isinstance(x, tuple) else [x]


@contextlib.contextmanager
def deferred_faults():
    """Checked launches inside the block do not read their fault record
    back (no synchronize after each: for timing); on leaving the block
    without an exception, each library's record is read once and a fault
    raises IndexError."""
    libs = {}
    real = _build.take_fault
    _build.take_fault = lambda lib: libs.setdefault(id(lib), lib) and None
    try:
        yield
    finally:
        _build.take_fault = real
    for lib in libs.values():
        fault = real(lib)
        if fault is not None:
            raise IndexError(_build.fault_message(fault))


def hold_checked(name, arg_list, time_ms=None):
    """Each call of kernel `name` through the normal build, the checked
    build (debug_mode without NaN checks; a fault raises IndexError) and
    the plain version. Returns dict(calls, mismatches_normal,
    mismatches_plain, max_abs_err, shapes, ms, checked_ms); the two time
    lists (time_ms(fn) of each call) only with time_ms."""
    wrappers, plain = covered_kernels()
    wr = wrappers[name]
    rec = dict(calls=len(arg_list), mismatches_normal=0, mismatches_plain=0, max_abs_err=0.0,
               shapes=[list(a[0].shape) for a in arg_list], ms=[], checked_ms=[])
    for args in arg_list:
        normal = _outputs(wr(*args))
        with debug_mode(nan_checks=False):
            checked = _outputs(wr(*args))
        bad, _, _ = KC.compare(checked, normal)
        rec["mismatches_normal"] += bad
        bad, err, _ = KC.compare(checked, _outputs(plain[name](*args)))
        rec["mismatches_plain"] += bad
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del normal, checked
        if time_ms is not None:
            rec["ms"].append(time_ms(lambda: wr(*args)))
            with debug_mode(nan_checks=False), deferred_faults():
                rec["checked_ms"].append(time_ms(lambda: wr(*args)))
    return rec


def guard_lines(text, extent):
    """Source lines spanned by the JXL_CHECK / JXL_CHECK_N guards of a
    source's text whose arguments name `extent`."""
    lines = set()
    for m in re.finditer(r"\bJXL_CHECK(?:_N)?\(", text):
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[j], 0)
            j += 1
        if re.search(rf"(?<![\w.]){re.escape(extent)}(?!\w)", text[m.end():j - 1]):
            first = text.count("\n", 0, m.start()) + 1
            lines.update(range(first, text.count("\n", 0, j) + 2))
    return lines


def _captured(name, args):
    """(wrapper, library name, bind, entry, what, launcher args, extents)
    of the launch wrapper `name` makes on args, which is not made, and the
    outputs the wrapper allocated (kept alive with the pointers)."""
    wrappers, _ = covered_kernels()
    seen = []
    mods = (AQ, SK, QK, TK, PK)
    real = [m.launch for m in mods]
    for m in mods:
        m.launch = lambda *a: seen.append(a)
    try:
        outs = wrappers[name](*args)
    finally:
        for m, f in zip(mods, real):
            m.launch = f
    return seen[0], outs


def inject(name, args):
    """One injected fault of kernel `name` on a call's args (see the module
    docstring). Returns dict(fault, expected_lines, canary_intact,
    normal_after: mismatches of the next normal launch against the plain
    version, ok)."""
    (_, lib_name, bind, entry, what, largs, extents), outs = _captured(name, args)
    i, extent_name = INJECT[name]
    n = extents[i]
    target = next(t for t in _outputs(outs) if t.data_ptr() == largs[i])
    buf = torch.empty(n + CANARY, dtype=target.dtype, device=target.device)
    buf.view(torch.int32).fill_(SENTINEL)
    largs, extents = list(largs), list(extents)
    largs[i], extents[i] = buf.data_ptr(), n - 1
    lib = _build.checked_library(lib_name, bind)
    _build.check(getattr(lib, entry)(*largs, *extents), what)
    fault = _build.take_fault(lib)
    canary = bool((buf.view(torch.int32)[n - 1:] == SENTINEL).all())
    del outs, buf
    wrappers, plain = covered_kernels()
    after, _, _ = KC.compare(_outputs(wrappers[name](*args)), _outputs(plain[name](*args)))
    source = next(src for kn, src in _build.FAULT_KERNELS.values() if kn == name)
    lines = guard_lines((_build.CSRC / source).read_text(), extent_name)
    ok = (fault is not None and fault["kernel"] == name and fault["line"] in lines
          and fault["extent"] == n - 1 and canary and after == 0)
    return dict(fault=fault, expected_lines=sorted(lines), canary_intact=canary,
                normal_after=after, ok=ok)
