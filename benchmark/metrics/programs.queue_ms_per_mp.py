"""Programs: host milliseconds a megapixel inside ops/programs.run, which
queues a program (eagerly, as a capture, or as a replay with its input
copies and output clones) and does not wait for the card; host clock."""
from jxlbench import readers as R

SPANS = R.PROGRAMS


def read(run):
    if not R.count(run.spans, "programs"):
        return None
    return R.per_mp_ms(run, R.total(run.spans, "programs"))
