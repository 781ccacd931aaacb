"""The mesh: host milliseconds a megapixel inside the port's spans
mesh:program_a and mesh:program_b (DeviceEncodeJob on a mesh: programs A
and B queued op by op, eagerly) less the collectives' spans inside them:
the host queueing that captured programs would take away."""
from jxlbench import program_spans as P

COLLECTIVES = P.named("mesh.psum", "mesh.all_gather", "mesh.exchange", "mesh.gather0")


def read(run):
    return P.ms_per_mp(run, P.named("mesh:program_a", "mesh:program_b"), COLLECTIVES)
