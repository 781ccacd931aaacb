"""Program B (ops/dc_kernels.pack_batch_sections): device milliseconds a
megapixel of the operations launched inside programs.run for it, every
dispatch included, from the trace alone."""
from jxlbench import readers as R

SPANS = R.PROGRAMS


def read(run):
    t = R.program_device_seconds(run, R.PROGRAM_B)
    return None if not t else R.per_mp_ms(run, t)
