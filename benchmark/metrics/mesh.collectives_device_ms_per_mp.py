"""The mesh: device milliseconds a megapixel of the NCCL kernels on rank
0's card in the traced window (every collective of parallel/sharding.Mesh),
from the trace alone. A collective's kernel runs from its launch until
the last rank has joined it, so this time holds the waits for the other
ranks as well as the transfers. Nothing where the trace holds no NCCL
kernel."""
from jxlbench import readers as R


def nccl_seconds(run):
    """Device seconds of the window's NCCL kernels; None where none ran."""
    t = sum(v for k, v in R.kernel_seconds(run).items() if k.startswith("nccl"))
    return t or None


def read(run):
    t = nccl_seconds(run)
    return None if t is None else R.per_mp_ms(run, t)
