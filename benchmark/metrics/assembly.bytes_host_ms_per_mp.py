"""Assembly: host milliseconds a megapixel inside the port's span
assembly.bytes (assemble_codestream: the codestream's final to_bytes)."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.named("assembly.bytes"))
