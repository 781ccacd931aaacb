"""The mesh: host milliseconds a megapixel inside the port's spans of the
collectives (parallel/sharding.Mesh: mesh.psum, mesh.all_gather,
mesh.exchange, mesh.gather0), self time: the host's share of queueing
them."""
from jxlbench import program_spans as P

COLLECTIVES = P.named("mesh.psum", "mesh.all_gather", "mesh.exchange", "mesh.gather0")


def read(run):
    return P.ms_per_mp(run, COLLECTIVES)
