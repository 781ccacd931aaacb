"""The mesh: device milliseconds a megapixel of rank 0's own work in the
mesh programs, the operations other than NCCL kernels launched under the
port's spans mesh:program_a and mesh:program_b: the trace ties each
operation to the innermost range around its launch, so those under the
collectives' spans inside the programs (mesh.psum, mesh.all_gather,
mesh.exchange, and torch's nccl:* ranges of them) count too; the gather
of the section words (mesh.gather0, nccl:gather) runs outside the
programs and does not. Nothing where the trace holds no mesh:program_*
span."""
from jxlbench import program_spans as P
from jxlbench import readers as R
from jxlbench import trace as T

PROGRAMS = ("mesh:program_a", "mesh:program_b")
INSIDE = PROGRAMS + ("mesh.psum", "mesh.all_gather", "mesh.exchange")


def _inside(launcher):
    return launcher in INSIDE or (launcher.startswith("nccl:") and launcher != "nccl:gather")


def read(run):
    if not P.count(run, P.named(*PROGRAMS)):
        return None
    lo, hi = run.trace.window
    t = sum(min(o.end, hi) - max(o.start, lo) for o in run.trace.in_window()
            if _inside(o.launcher) and not T.kernel_name(o.name).startswith("nccl"))
    return R.per_mp_ms(run, t)
