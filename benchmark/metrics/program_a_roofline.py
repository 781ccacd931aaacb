"""Program A: its least time over its device time, in %. The least time is
the bytes the program must move at the card's peak memory rate: the
uploaded pixels read once and the AC tokens written once (4 bytes each,
at the golden model's count of tokens a pixel on the images the run
compared), from the inputs' shapes and never from the program's buffers."""
from jxlbench import readers as R

SPANS = R.PROGRAMS


def read(run):
    t = R.program_device_seconds(run, R.PROGRAM_A)
    w = run.work
    if not t or w.get("tokens") is None:
        return None
    least = (w["pixel_bytes"] + 4 * w["tokens"]) / run.peak_bytes_per_s
    return 100.0 * least / t
