"""Assembly: host milliseconds a megapixel inside the port's span
assembly.globals (assemble_codestream: the DC and AC globals, which
serialize each image's entropy codes)."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.named("assembly.globals"))
