"""Programs: host milliseconds a megapixel inside the port's spans
programs:<name>.replay (ops/programs.ProgramCache.run: the launch of a
captured graph, every program), host time only."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.replays)
