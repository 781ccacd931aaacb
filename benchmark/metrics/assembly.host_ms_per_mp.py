"""Assembly: host milliseconds a megapixel inside DeviceEncodeJob.result
(the section plan's checks, the section words turned into writers,
assemble_codestream and the native packer) less pack(), the waits for the
card (transfer.Fetch.numpy) and program B's re-dispatches (programs.run)."""
from jxlbench import readers as R

SPANS = {**R.RESULT, **R.PACK, **R.WAIT, **R.PROGRAMS}


def read(run):
    if not R.count(run.spans, "result"):
        return None
    return R.per_mp_ms(run, R.exclusive(run.spans, "result", {"pack", "wait", "programs"}))
