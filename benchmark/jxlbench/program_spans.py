"""The port's own spans in a traced run (jxl_tiny_tpu_torch/utils/
profiling.span): record_function ranges that the encoder opens around its
stages while a profiler records, read from the trace's host ranges on the
main thread (run.trace.ranges) inside the traced window. A program
without such spans leaves these readers nothing to read: they return
None and do not raise."""
from . import stats


def _ranges(run):
    """(start, end, name) of the window's ranges, clipped to it, sorted by
    start; the window's own range left out."""
    if run.trace is None:
        return []
    lo, hi = run.trace.window
    return [(max(s, lo), min(e, hi), name) for s, e, name in run.trace.ranges
            if e > lo and s < hi and name != "window"]


def named(*names):
    """A test of a range's name: one of `names`."""
    return lambda name: name in names


def replays(name):
    """Any program's graph launch: programs:<program>.replay."""
    return name.startswith("programs:") and name.endswith(".replay")


def count(run, match) -> int:
    """Ranges of the window whose name `match` accepts."""
    return sum(1 for r in _ranges(run) if match(r[2]))


def self_seconds(run, match, minus=named()):
    """Seconds inside the outermost ranges whose name `match` accepts, each
    less the part that ranges inside it whose name `minus` accepts cover;
    None where the window holds no such range."""
    rs = _ranges(run)
    total, found, outer_end = 0.0, False, float("-inf")
    for i, (s, e, name) in enumerate(rs):
        if not match(name) or s < outer_end:
            continue
        found, outer_end = True, e
        inner, k = [], i + 1
        while k < len(rs) and rs[k][0] < e:
            if minus(rs[k][2]):
                inner.append(rs[k][:2])
            k += 1
        total += (e - s) - stats.busy(inner, s, e)
    return total if found else None


def ms_per_mp(run, match, minus=named()):
    """self_seconds as host milliseconds a megapixel of the window."""
    t = self_seconds(run, match, minus)
    return None if t is None or not run.megapixels else t * 1e3 / run.megapixels
