"""The kernel checks that chip_smoke.py and the mesh's rank functions
(tools/multihost_dryrun.py) share: the on-path kernel wrappers and their
plain versions, the exact comparison of their outputs, the recording of a
run's kernel calls, and the count of the encoder's program runs with the
launches they imply. Every kernel time is taken with
utils/profiling.device_time."""
import torch


def on_path_kernels():
    """({name: wrapper}, {name: plain version}) of the six kernels the
    encode path launches; each plain version takes the wrapper's
    arguments."""
    from ..ops import aq_kernel as AQ
    from ..ops import pack_kernels as PK
    from ..ops import quantize_kernel as QK
    from ..ops import strategy_kernel as SK
    from ..ops import tokenize_kernel as TK

    wrappers = {"aq_field": AQ.aq_field, "estimate_partials": SK.estimate_partials,
                "quantize_cells": QK.quantize_cells, "tokenize_rows": TK.tokenize_rows,
                "compact_rows": PK.compact_rows, "copy_sections": PK.copy_sections}
    plain = {
        "aq_field": lambda xyb, d: AQ.aq_field_plain(xyb, *AQ.aq_constants(d)),
        "estimate_partials": SK.estimate_partials_plain,
        "quantize_cells": QK.quantize_cells_plain,
        "tokenize_rows": lambda x, meta, t: TK.tokenize_rows_plain(
            x, meta, t.freq_tab, t.nnz_thresh0),
        "compact_rows": PK.compact_rows_plain,
        "copy_sections": PK.copy_sections_plain,
    }
    return wrappers, plain


def max_abs_err(a, b):
    if a.dtype.is_floating_point:
        d = (a.double() - b.double()).abs()
        return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def compare(outs_k, outs_p, nan_ok=False):
    """Kernel outputs against plain ones, exactly (bitwise for floats; with
    nan_ok a NaN equals any NaN, whatever its payload). Returns
    (mismatching elements, max_abs_err, elements NaN in both); raises when
    an output's shape or type differs."""
    err, bad, nans = 0.0, 0, 0
    for k, p in zip(outs_k, outs_p):
        if k.shape != p.shape or k.dtype != p.dtype:
            raise ValueError(f"kernel output {k.dtype}{tuple(k.shape)} vs plain "
                             f"{p.dtype}{tuple(p.shape)}")
        if k.dtype.is_floating_point:
            same = k.view(torch.int32) == p.view(torch.int32)
            if nan_ok:
                both = torch.isnan(k) & torch.isnan(p)
                nans += int(both.sum())
                same = same | both
                k, p = torch.where(both, 0.0, k), torch.where(both, 0.0, p)
        else:
            same = k == p
        bad += int((~same).sum())
        err = max(err, max_abs_err(k, p))
    return bad, err, nans


def recorded(fn):
    """fn() with every on-path kernel wrapper's arguments recorded, call by
    call: (fn's result, {kernel: [args, ...]}, {kernel: launches fn made})."""
    wrappers, _ = on_path_kernels()
    calls = {name: [] for name in wrappers}
    real = {}
    for name, wr in wrappers.items():
        cls = type(wr)
        real[cls] = cls.__call__
        wr.launches = 0

        def recording_call(self, *args, _name=name, _real=cls.__call__):
            calls[_name].append(args)
            return _real(self, *args)

        cls.__call__ = recording_call
    try:
        out = fn()
    finally:
        for cls, f in real.items():
            cls.__call__ = f
    return out, calls, {name: wr.launches for name, wr in wrappers.items()}


def hold_calls(calls, time_ms=None):
    """Each recorded call's kernel output against its plain version, bit
    for bit. Returns {kernel: dict(calls, mismatches, max_abs_err, shapes,
    ms)}; ms (the kernel's time a call, from time_ms(fn)) only when
    time_ms is given."""
    wrappers, plain = on_path_kernels()
    out = {}
    for name, arg_list in calls.items():
        rec = dict(calls=len(arg_list), mismatches=0, max_abs_err=0.0,
                   shapes=[list(a[0].shape) for a in arg_list], ms=[])
        for args in arg_list:
            ks, ps = wrappers[name](*args), plain[name](*args)
            ks, ps = (list(ks), list(ps)) if isinstance(ks, tuple) else ([ks], [ps])
            bad, err, _ = compare(ks, ps)
            rec["mismatches"] += bad
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if time_ms is not None:
                rec["ms"].append(time_ms(lambda a=args, wr=wrappers[name]: wr(*a)))
        out[name] = rec
    return out


def count_programs(module, names):
    """Wrap the program functions `names` of `module` (the encoder's, or
    parallel.sharding's, which the encoder calls through the module) to
    count their runs: (runs {name: 0, ...}, restore())."""
    runs = {n: 0 for n in names}
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def run(*args, **kwargs):
            runs[n] += 1
            return real[n](*args, **kwargs)
        return run

    for n in names:
        setattr(module, n, wrap(n))
    return runs, lambda: [setattr(module, n, f) for n, f in real.items()]


def expected_launches(a_runs, b_runs):
    """Each kernel once a program: the four program A kernels once an A,
    compact_rows once an A (tokens) and twice a B (AC and DC words),
    copy_sections twice a B (both buffers compacted)."""
    return {"aq_field": a_runs, "estimate_partials": a_runs, "quantize_cells": a_runs,
            "tokenize_rows": a_runs, "compact_rows": a_runs + 2 * b_runs,
            "copy_sections": 2 * b_runs}
