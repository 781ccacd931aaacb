"""The ranks of a mesh cell (benchmark/loops/mesh.py): where each one runs,
how rank 0 starts the others, and the request protocol they all follow.

Placement. Rank r drives card r. The cpus this process may use are split
in order into one set a rank, disjoint and of one size (split_cpus); a
child rank binds itself to its set before it imports torch, rank 0, the
run's own process, binds every thread it has. Each rank sizes its thread
pools to its set and first touches its pool of images after it is bound:
the children make theirs from the seed, rank 0 copies the one that
make_pool made. Binding acts on the benchmark's own processes only
(os.sched_setaffinity), and rank 0 takes its old cpus back when the loop
ends.

Protocol. Two process groups join the ranks: the mesh's (NCCL on the
cards, gloo on the CPU) and a gloo side group on the host. Before each
request rank 0 broadcasts (pool index, op) on the side group, the front
end's fan-out (fan_out), and every rank then calls encode_image_device_mesh on that
image with the op's dc_exchange; op STOP ends the loop, and every rank
then reports what it served. Before the first request the ranks check
that they hold the same pool.

Failure. A child that raises exits non-zero; rank 0 watches its children
and ends its own process at once when one exits before it is told to stop.
A child whose parent is gone ends itself (its standard input closes).
Every wait has a timeout: the mesh group's collectives (GROUP_TIMEOUT_S),
the side group's (SIDE_TIMEOUT_S) and the children's exit (EXIT_TIMEOUT_S).

Nothing here imports torch at module level: a child binds its cpus
first.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import traceback
import zlib

STOP = 0
EXCHANGES = ("gather", "owner")  # op 1 + index
GROUP_TIMEOUT_S = 60.0
SIDE_TIMEOUT_S = 120.0
EXIT_TIMEOUT_S = 60.0
ABORT_GRACE_S = 1.0  # for a child that is ending on its own when rank 0 fails

def log(msg):
    print(msg, file=sys.stderr, flush=True)


def op_for(dc_exchange):
    return 1 + EXCHANGES.index(dc_exchange)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def split_cpus(allowed, n) -> list:
    """`n` disjoint sorted lists of cpus of one size, in order, from the
    `allowed` ones; raises when there are fewer cpus than ranks."""
    allowed = sorted(allowed)
    share = len(allowed) // n
    if not share:
        raise ValueError(f"{len(allowed)} cpus cannot give {n} ranks one each")
    return [allowed[r * share: (r + 1) * share] for r in range(n)]


def bind(cpus):
    """Every thread of this process onto `cpus`; returns the process's
    cpus before."""
    before = sorted(os.sched_getaffinity(0))
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (ProcessLookupError, OSError):  # a thread that just ended
            pass
    return before


def pool_digest(images) -> list:
    """A checksum an image, to hold the ranks' pools equal."""
    return [zlib.crc32(memoryview(im).cast("B")) for im in images]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# What every rank does
# ---------------------------------------------------------------------------


class Rank:
    """One rank's side of the protocol: its groups, its mesh and its pool."""

    def __init__(self, enc, images, distance, rank, world, init, device, cpus):
        import datetime

        import torch.distributed as dist

        from jxl_tiny_tpu_torch.parallel import multihost
        from jxl_tiny_tpu_torch.parallel import sharding as SH

        self.enc, self.images, self.distance = enc, images, distance
        self.rank, self.world, self.cpus = rank, world, cpus
        self.served = 0
        multihost.initialize(init, world, rank, device, timeout_s=GROUP_TIMEOUT_S)
        self.side = dist.new_group(backend="gloo",
                                   timeout=datetime.timedelta(seconds=SIDE_TIMEOUT_S))
        self.mesh = SH.make_mesh(device)

    def exchange_objects(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.side)
        return out

    def check_pools(self):
        """Raise on every rank unless all of them hold the same pool."""
        digests = self.exchange_objects(pool_digest(self.images))
        if any(d != digests[0] for d in digests):
            raise ValueError(f"the ranks' pools differ: {digests}")

    def message(self, idx=0, op=STOP):
        """Rank 0 sends (idx, op); every rank returns what rank 0 sent."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([idx, op], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.side)
        return int(t[0]), int(t[1])

    def encode(self, idx, op):
        self.served += 1
        return self.enc.encode_image_device_mesh(self.images[idx], self.distance,
                                                 mesh=self.mesh,
                                                 dc_exchange=EXCHANGES[op - 1])

    def report(self) -> list:
        """Every rank's account of itself, on every rank."""
        import torch

        from .main import forbidden_modules

        peak = (torch.cuda.max_memory_reserved(self.mesh.device)
                if self.mesh.device.type == "cuda" else 0)
        return self.exchange_objects(dict(
            rank=self.rank, served=self.served, cpus=len(self.cpus), peak_reserved=peak,
            forbidden=forbidden_modules()))


def fan_out(world, rank, idx, op):
    """Rank 0 sends one request (idx, op) to the `world` ranks of its mesh.
    The rank count is an argument so that a traced run's span around this
    call can take it as its label (metrics/mesh.collectives_roofline)."""
    rank.message(idx, op)


def serve(rank):
    """A child rank's loop: encode what rank 0 sends until it stops."""
    while True:
        idx, op = rank.message()
        if op == STOP:
            return
        rank.encode(idx, op)


def _exit_with_parent():
    """End this process when the parent's end of standard input closes."""
    def watch():
        while sys.stdin.buffer.read(1 << 16):
            pass
        os._exit(70)

    threading.Thread(target=watch, daemon=True).start()


def child_main(spec_json):
    """A child rank, from rank 0's description of it (Ranks): exits
    0 when rank 0 stopped it and 1 when it raised."""
    try:
        _child(json.loads(spec_json))
    except BaseException:
        traceback.print_exc()
        code = 1
    else:
        code = 0
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _child(a):
    if a["cpus"]:
        os.sched_setaffinity(0, a["cpus"])
    _exit_with_parent()
    import torch

    if a["cpus"]:
        torch.set_num_threads(len(a["cpus"]))
    from jxl_tiny_tpu_torch import encoder

    from .inputs import make_pool

    rank = Rank(encoder, None, a["distance"], a["rank"], a["world"], a["init"], a["device"],
                a["cpus"])
    pool = make_pool(a["root"], a["config"], a["traffic"], a["seed"], a["bench_dir"])
    rank.images = [r[0] for r in pool.requests]
    rank.check_pools()
    serve(rank)
    rank.report()
    import torch.distributed as dist

    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rank 0: the run's own process
# ---------------------------------------------------------------------------


class Ranks:
    """Rank 0 of a mesh of `world` ranks and the children it started."""

    def __init__(self, enc, pool, traffic, distance, bench_dir):
        self.world = traffic["ranks"]
        self.kind = traffic.get("device", "cuda")
        self.children = []
        self._stopping = False
        self._old_cpus = None
        self.plan = split_cpus(os.sched_getaffinity(0), self.world)
        log(f"mesh: {self.world} ranks on cpus {self.plan}")
        self._bind_self()
        self._prebuild()
        init = f"tcp://127.0.0.1:{free_port()}"
        try:
            self._start_children(pool, traffic, distance, bench_dir, init)
            # First touch of rank 0's pool on its own cpus.
            for req in pool.requests:
                req[:] = [im.copy() for im in req]
            self.rank = Rank(enc, [r[0] for r in pool.requests], distance, 0, self.world,
                             init, self._device(0), self.plan[0])
            self.rank.check_pools()
        except BaseException:
            self.abort()
            raise

    def _device(self, r):
        return f"cuda:{r}" if self.kind == "cuda" else "cpu"

    def _bind_self(self):
        import torch

        self._old_cpus = bind(self.plan[0])
        self._old_threads = torch.get_num_threads()
        torch.set_num_threads(len(self.plan[0]))

    def _prebuild(self):
        """The kernels and the native packer, built once here so that the
        children only load them."""
        from jxl_tiny_tpu_torch.cpp import build as native

        if self.kind == "cuda":
            from jxl_tiny_tpu_torch.ops import _build

            _build.build_all()
        native.native_packer()

    def _start_children(self, pool, traffic, distance, bench_dir, init):
        src = getattr(pool, "source", None)
        if src is None:
            raise ValueError("a mesh cell's generator must give its pool a `source`")
        root = src["root"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [bench_dir, root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                 if p]))
        for r in range(1, self.world):
            spec = dict(src, distance=distance, rank=r, world=self.world, init=init,
                        device=self._device(r), cpus=self.plan[r], bench_dir=bench_dir)
            threads = str(len(self.plan[r]))
            proc = subprocess.Popen(
                [sys.executable, "-c",
                 "import sys; from jxlbench.ranks import child_main; child_main(sys.argv[1])",
                 json.dumps(spec)],
                stdin=subprocess.PIPE, stdout=sys.stderr, cwd=root,
                env=dict(env, OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads,
                         OPENBLAS_NUM_THREADS=threads))
            self.children.append(proc)
            threading.Thread(target=self._watch, args=(r, proc), daemon=True).start()

    def _watch(self, r, proc):
        rc = proc.wait()
        if self._stopping:
            return
        log(f"mesh: rank {r} of {self.world} exited with code {rc} before the loop "
            f"ended; ending the run")
        for p in self.children:
            if p.poll() is None:
                p.kill()
        os._exit(1)

    def request(self, idx, op):
        """One request on every rank; rank 0's codestream."""
        fan_out(self.world, self.rank, idx, op)
        return self.rank.encode(idx, op)

    def close(self):
        """Stop the children, hold every rank's account to rank 0's, take
        the groups down and rank 0's old cpus back."""
        import torch
        import torch.distributed as dist

        self._stopping = True
        self.rank.message(0, STOP)
        reports = self.rank.report()
        dist.destroy_process_group()
        for p in self.children:
            p.wait(timeout=EXIT_TIMEOUT_S)
            p.stdin.close()
        self._restore()
        log("mesh: " + json.dumps(reports))
        bad = [r for r in reports if r["served"] != self.rank.served or r["forbidden"]]
        codes = [p.returncode for p in self.children]
        if bad or any(codes):
            raise RuntimeError(f"mesh: rank 0 sent {self.rank.served} requests; ranks {bad}; "
                               f"children's exit codes {codes}")
        torch.set_num_threads(self._old_threads)

    def _restore(self):
        if self._old_cpus is not None:
            bind(self._old_cpus)
            self._old_cpus = None

    def abort(self):
        """Kill the children (rank 0 failed), naming any that ended first
        (rank 0's collective fails when a peer exits, which can come
        before _watch sees the exit), and take rank 0's cpus back."""
        self._stopping = True
        for r, p in enumerate(self.children, 1):
            try:
                rc = p.wait(timeout=ABORT_GRACE_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=EXIT_TIMEOUT_S)
            else:
                log(f"mesh: rank {r} of {self.world} exited with code {rc} before the "
                    f"loop ended; ending the run")
        self._restore()
