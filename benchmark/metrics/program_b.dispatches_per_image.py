"""Program B: its runs a window's image (programs.run calls for it over
the images encoded). One is the least; a second follows where the DC
sections outgrow their word budget (ow_dc) and B runs again."""
from jxlbench import readers as R

SPANS = R.PROGRAMS


def read(run):
    n = R.count(run.spans, "programs", R.PROGRAM_B)
    return n / run.images if n and run.images else None
