"""The mesh: the collectives' least time over the device time of rank 0's
NCCL kernels, in %. The least time is the bytes that rank 0's links must
carry in the busier direction of each collective, counted from the
images' geometry and the rank count by benchmark/roofline/
mesh_collectives.py (never from the program's counters), at the NVLink
rate of one direction. The NCCL time holds the waits for the other ranks
(mesh.collectives_device_ms_per_mp). The rank count is the cell's own
(its traffic's `ranks`), read as the label of the span around rank 0's
fan-out of each request (jxlbench/ranks.fan_out)."""
from jxlbench import spec

NCCL = spec.load_module("metrics", "mesh.collectives_device_ms_per_mp")
SPANS = {"mesh.fan_out": {"target": "jxlbench.ranks:fan_out", "label_arg": 0}}


def world(run):
    """The rank count of the window's requests; None where none was fanned
    out."""
    counts = {s.label for s in run.spans if s.name == "mesh.fan_out"}
    return int(counts.pop()) if len(counts) == 1 else None


def read(run):
    t = NCCL.nccl_seconds(run)
    mod = run.roofline.get("mesh_collectives")
    if t is None or mod is None:
        return None
    least = mod.least_bytes(run.work, world(run))
    return None if least is None else 100.0 * least / mod.LINK_BYTES_PER_S / t
