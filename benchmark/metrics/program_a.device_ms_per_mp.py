"""Program A (ops/pipeline.analyze_batch_packed): device milliseconds a
megapixel of the operations launched inside programs.run for it, from the
torch.profiler trace alone (nothing where it holds none)."""
from jxlbench import readers as R

SPANS = R.PROGRAMS


def read(run):
    t = R.program_device_seconds(run, R.PROGRAM_A)
    return None if not t else R.per_mp_ms(run, t)
