"""Assembly: host milliseconds a megapixel inside the port's span
assembly.toc (assemble_codestream: the file and frame headers, the table
of contents and every section's bytes appended)."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.named("assembly.toc"))
