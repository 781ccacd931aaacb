"""A closed loop with one client over a mesh of ranks, one card each: every
request is one encode_image_device_mesh(image, distance) call on every
rank (its groups sharded over the ranks; rank 0 returns the codestream),
the next sent when rank 0 has the last one's bytes.

Rank 0 is the run's own process; warm starts the other ranks, binds every
rank to its own share of the cpus and brings up their process groups
(jxlbench/ranks.py). Before each request rank 0 broadcasts its pool index
to the other ranks (the front end's fan-out, inside the window). The
window runs on rank 0's clock, from the first fan-out to rank 0's bytes of
the last request sent before the deadline; then the other ranks stop and
report, and a rank that served another count of requests fails the run.

The traffic mix gives `ranks` (one a card), `dc_exchange` ("gather" or
"owner") and, for a run on the CPU, `"device": "cpu"` (gloo).
"""
import time

from jxlbench import ranks as R
from jxlbench import spec
from jxlbench.drivers import Request, Window

_mesh = None  # rank 0's side of the mesh, from warm to the end of run


def warm(enc, pool, traffic, distance):
    """Bring up the ranks, then send every request of the pool twice; then
    hold rank 0's bytes of the pool's first image to encode_image_device's
    on rank 0's card (the mesh promises them equal for any rank count),
    and free that encode's programs."""
    global _mesh
    if traffic.get("clients", 1) != 1:
        raise ValueError("a closed loop drives one client")
    _mesh = R.Ranks(enc, pool, traffic, distance, spec.BENCH_DIR)
    try:
        op = R.op_for(traffic.get("dc_exchange", "gather"))
        for i in list(range(len(pool.requests))) * 2:
            data = _mesh.request(i, op)
            if i == 0:
                first = data
        single = enc.encode_image_device(pool.requests[0][0], distance)
        if single != first:
            raise AssertionError(
                f"the mesh's codestream of image 0 ({len(first)} B) is not "
                f"encode_image_device's ({len(single)} B)")
        _free_single()
    except BaseException:
        _mesh.abort()
        raise


def _free_single():
    """Drop the one-card encode's programs and its memory, and the peak it
    left, so that the run's peak is the mesh's."""
    import torch
    from jxl_tiny_tpu_torch.ops import programs

    programs.clear_programs()
    if _mesh.kind == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def run(enc, pool, traffic, distance, seconds, order, clock=time.perf_counter) -> Window:
    """One window of `seconds` on the mesh that warm brought up; the other
    ranks stop at its end. A request that raises on rank 0 ends the run:
    the ranks' collectives would no longer pair up."""
    op = R.op_for(traffic.get("dc_exchange", "gather"))
    reqs = []
    try:
        t0 = clock()
        deadline = t0 + seconds
        while not reqs or clock() < deadline:
            idx = next(order)
            r = Request(idx, clock())
            r.outputs = [_mesh.request(idx, op)]
            r.end = clock()
            reqs.append(r)
    except BaseException:
        _mesh.abort()
        raise
    _mesh.close()
    return Window(t0, reqs[-1].end, reqs)
