"""Host codes: host milliseconds a megapixel inside DeviceEncodeJob.pack
(program A's totals and histograms handled, each image's entropy codes
built, program B's inputs made) less the time it waits for the card
(transfer.Fetch.numpy) and queues program B (programs.run)."""
from jxlbench import readers as R

SPANS = {**R.PACK, **R.WAIT, **R.PROGRAMS}


def read(run):
    if not R.count(run.spans, "pack"):
        return None
    return R.per_mp_ms(run, R.exclusive(run.spans, "pack", {"wait", "programs"}))
