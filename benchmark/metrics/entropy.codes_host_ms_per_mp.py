"""Host codes: host milliseconds a megapixel inside the port's span
codes.build (DeviceEncodeJob.pack: each image's AC and DC entropy codes
built from program A's histograms)."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.named("codes.build"))
