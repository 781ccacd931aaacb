"""The hand-written kernels of programs A and B (csrc/*.cu): the sum of
their least times over the sum of their device times in the traced window,
in %. Each kernel's least time comes from benchmark/roofline/<kernel>.py:
the bytes the window's work needs it to move (each input byte read once,
each output byte written once) at the card's peak memory rate. A kernel
with no such file, or not in the trace, is left out of both sums; each
kernel's own share goes to standard error."""
import sys

from jxlbench import readers as R


def read(run):
    if run.trace is None or run.work.get("tokens") is None:
        return None
    secs = R.kernel_seconds(run)
    least = spent = 0.0
    for name, mod in sorted(run.roofline.items()):
        if secs.get(name):
            k_least = mod.least_bytes(run.work) / run.peak_bytes_per_s
            print(f"roofline {name}: {100.0 * k_least / secs[name]:.4f}% "
                  f"({k_least * 1e3:.4f} ms least, {secs[name] * 1e3:.4f} ms on the device)",
                  file=sys.stderr)
            least += k_least
            spent += secs[name]
    return 100.0 * least / spent if spent else None
