"""Device: the share of the traced window in which no kernel, copy or fill
runs on any stream of the card (the union of the trace's device
intervals), in %."""
from jxlbench import stats


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    busy = stats.busy([(o.start, o.end) for o in run.trace.ops], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
