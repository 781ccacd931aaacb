"""Programs: the share of programs.run calls in the window that replayed a
captured graph (the cache's own replay counter, programs.stats(), over the
calls counted at the wrapper). Below 100% the window ran programs eagerly
or captured them: a key seen late, or evicted and captured again."""
from jxlbench import readers as R

SPANS = R.PROGRAMS


def read(run):
    calls = R.count(run.spans, "programs")
    if not calls:
        return None
    return 100.0 * (run.stats_after["replays"] - run.stats_before["replays"]) / calls
