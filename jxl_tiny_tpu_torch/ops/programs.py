"""The encoder's compiled device programs: the counterpart of `jax.jit`.

The JAX package runs each of its device programs (program A, program B and
the one-pass static program) as one compiled executable, cached on the
input shapes and the static arguments. Here a program is a plain function
on tensors (`fn(*inputs) -> dict of tensors`, queued op by op) and its key
(`program_key`): the program's name, the JAX package's static arguments
for it (distance, inv_scale, scale, scale_dc, x_qm_mul, cap, cfl, blocks;
for program B ow_ac, wcap_ac, ow_dc, wcap_dc, compact_ac, compact_dc),
`kernels`, the identity of the encoder tables it reads, the inputs' shapes
and dtypes, and the device.

On the card a key's first call runs the program eagerly: its warm-up,
which builds the nvcc libraries and fills the cached device constants (each
copies from the host on its first call and so cannot be captured). Its
second call captures it as a torch.cuda.CUDAGraph, into a memory pool of
its own, and replays it; every later call replays it: one launch queues
the whole program. A key called once (an image size seen once) is never
captured, so it costs what an eager run costs.

One graph a key. A JAX call returns fresh buffers, while a replay writes
over the same ones. So a call copies its inputs into the graph's input
buffers, replays, and returns clones of the graph's outputs, all on the
compute stream in the order of the calls: no later replay can overwrite
what an earlier call's caller still reads, whatever it keeps in flight.
When the captured pools hold more than POOL_SHARE of the card's memory,
the least recently used keys are dropped. `clear_programs()` (the
counterpart of `jax.clear_caches()`) drops every graph and its pool.

Launch accounting: ops/_build.launch counts each kernel launch on its
wrapper. While a thread captures, its launches go to the capture's record
instead (the card runs nothing then), and every replay adds the record to
the wrappers, so `launches` stays what the card ran.

Threads: one lock serializes the cache's calls (warm-ups, captures,
replays, clearing). A capture uses CUDA's thread-local capture mode, so
another thread's eager work on the card goes on beside it, and its
launches count on the wrappers as usual.

Spans (utils/profiling.span): a call opens programs:<name>.key (the key
made), .eager (a key's first call), .capture, .copy_in, .replay (the graph
launch) and .clone_out, each name starting with programs:<name>, so that a
trace gives the device work queued under any of them to the program.

Eager runs, by explicit rule (`graphs_enabled`): on the CPU; inside
`eager()` (the counterpart of `jax.disable_jit()`: the programs run op by
op on the card, which is how the tests and chip_smoke.py get the eager
reference); inside utils/debug.debug_mode(), which also clears the cache
on entry and on exit, since the checked kernels and the NaN checks
synchronize and cannot be captured. The encoder adds two of its own: a
mesh (gloo collectives cannot be captured) and the host-packed path. On
the card a capture that fails raises CaptureError naming the key and the
op; nothing runs eagerly in its place.
"""
import contextlib
import contextvars
import functools
import os
import threading
import time
import traceback
from collections import Counter
from typing import NamedTuple

import torch

from ..tables import canonical_device
from ..utils import debug
from ..utils.profiling import span
from . import _build

# The most of the card's memory the captured programs' pools may hold
# before the least recently used are dropped.
POOL_SHARE = 0.25

_EAGER = contextvars.ContextVar("jxl_tiny_tpu_torch_eager_programs", default=False)


@contextlib.contextmanager
def eager():
    """Run the programs inside the block op by op (no capture, no replay),
    as jax.disable_jit() does; the cache is left as it is."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def graphs_enabled(device) -> bool:
    """True where a program call goes through the cache: on the card,
    outside eager() and outside debug mode."""
    return _on_card(device) and not _EAGER.get() and not debug.active()


class Key(NamedTuple):
    name: str
    inputs: tuple  # ((shape, dtype), ...)
    static: tuple  # sorted (argument, value) pairs, kernels included
    device: str

    def __str__(self):
        ins = ", ".join(f"{str(d).replace('torch.', '')}{list(s)}" for s, d in self.inputs)
        return f"{self.name}({ins}; {', '.join(f'{k}={v}' for k, v in self.static)}; {self.device})"


def spec(t):
    """(shape, dtype) of a tensor: what a key holds of an input."""
    return tuple(t.shape), t.dtype


def program_key(name, inputs, static, device) -> Key:
    """The key of program `name` on inputs given as tensors or as (shape,
    dtype) specs, with its static arguments (a dict) on `device`."""
    specs = tuple(spec(t) if isinstance(t, torch.Tensor) else (tuple(t[0]), t[1])
                  for t in inputs)
    return Key(name, specs, tuple(sorted(static.items())), str(canonical_device(device)))


class CaptureError(RuntimeError):
    """A program could not be captured: the key and the op that failed."""


def _where(exc):
    """file:line (function: source) of the innermost frame of the package
    outside this module in an exception's traceback: the op that failed."""
    frames = traceback.extract_tb(exc.__traceback__)
    mine = [f for f in frames if "jxl_tiny_tpu_torch" in f.filename
            and os.path.basename(f.filename) != "programs.py"]
    if not mine:
        return "outside the package"
    f = mine[-1]
    return f"{f.filename.split('jxl_tiny_tpu_torch' + os.sep)[-1]}:{f.lineno} ({f.name}: {f.line})"


class CudaGraphs:
    """How the cache captures and replays on the card (the tests inject a
    fake with the same methods)."""

    def capture(self, fn, inputs):
        """fn captured into a new graph with a private memory pool, on the
        capture stream, in thread-local capture mode. Returns (graph,
        outputs, the bytes the pool reserved)."""
        from ..transfer import side_stream

        dev = inputs[0].device
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        with torch.cuda.device(dev), torch.cuda.stream(
                side_stream(canonical_device(dev), "capture")):
            # On the current device, made the inputs' own. torch.cuda.graph
            # would synchronize and empty the allocator's cache first.
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*inputs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated by the op that failed
                raise
            graph.capture_end()
        return graph, out, torch.cuda.memory_reserved(dev) - reserved

    def replay(self, graph):
        graph.replay()

    def destroy(self, graph):
        graph.reset()

    def synchronize(self, device):
        torch.cuda.synchronize(torch.device(device))

    def pool_limit(self, device):
        """POOL_SHARE of the card's memory, in bytes."""
        return int(POOL_SHARE * torch.cuda.get_device_properties(torch.device(device))
                   .total_memory)


class _Program:
    """One key's captured graph: its input buffers, its outputs, the
    launches a replay makes ({wrapper: n}), its pool's bytes, and the
    function it was captured from, whose closure keeps alive what the graph
    reads (the tables, the cached constants)."""

    def __init__(self, key, inputs, graph, outputs, launches, pool_bytes, fn):
        self.key, self.inputs, self.graph, self.outputs = key, inputs, graph, outputs
        self.launches, self.pool_bytes, self.fn = launches, pool_bytes, fn
        self.used = 0


@functools.lru_cache(maxsize=None)
def _span_names(name):
    """The span names of program `name`'s stages."""
    return {stage: f"programs:{name}.{stage}"
            for stage in ("key", "eager", "capture", "copy_in", "replay", "clone_out")}


class ProgramCache:
    """The captured programs by key, the keys seen once, and what they did."""

    def __init__(self, capturer=None, max_pool_bytes=None):
        self.capturer = CudaGraphs() if capturer is None else capturer
        self.max_pool_bytes = max_pool_bytes
        self._lock = threading.Lock()
        self.programs = {}  # key -> _Program
        self._seen = set()  # keys whose first (eager) call has run
        self._clock = 0
        self.replays = Counter()  # by program name
        self.by_key = {}
        self.evictions = 0

    def _stats(self, key):
        if key not in self.by_key:
            self.by_key[key] = dict(eager=0, captures=0, replays=0, warm_ms=None,
                                    capture_ms=[], pool_bytes=[])
        return self.by_key[key]

    def run(self, key, fn, inputs):
        """Program fn on these inputs under `key`: the key's first call runs
        it eagerly; the second captures it and replays; later calls copy the
        inputs into the graph's buffers and replay. Returns the outputs (on
        a replay, clones of the graph's)."""
        names = _span_names(key.name)
        with self._lock:
            prog = self.programs.get(key)
            if prog is None and key not in self._seen:
                st = self._stats(key)
                t = time.perf_counter()
                with span(names["eager"]):
                    out = fn(*inputs)
                st["warm_ms"] = (time.perf_counter() - t) * 1e3
                st["eager"] += 1
                self._seen.add(key)
                return out
            if prog is None:
                with span(names["capture"]):
                    prog = self._capture(key, fn, inputs)
            else:
                with span(names["copy_in"]):
                    for buf, t in zip(prog.inputs, inputs):
                        buf.copy_(t)
            with span(names["replay"]):
                self._replay(prog)
            with span(names["clone_out"]):
                return {k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in prog.outputs.items()}

    def _capture(self, key, fn, inputs):
        bufs = [torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
                for t in inputs]
        t = time.perf_counter()
        try:
            with _build.recording() as launches:
                graph, outputs, pool = self.capturer.capture(fn, bufs)
        except Exception as e:
            raise CaptureError(f"capture of program {key} failed at {_where(e)}: "
                               f"{type(e).__name__}: {e}") from e
        prog = _Program(key, bufs, graph, outputs, dict(launches), pool, fn)
        st = self._stats(key)
        st["captures"] += 1
        st["capture_ms"].append((time.perf_counter() - t) * 1e3)
        st["pool_bytes"].append(pool)
        self.programs[key] = prog
        self._evict(keep=prog)
        return prog

    def _replay(self, prog):
        self.capturer.replay(prog.graph)
        for w, n in prog.launches.items():
            w.launches += n
        self._clock += 1
        prog.used = self._clock
        self.replays[prog.key.name] += 1
        self._stats(prog.key)["replays"] += 1

    def pool_bytes(self):
        return sum(p.pool_bytes for p in self.programs.values())

    def _evict(self, keep):
        limit = self.max_pool_bytes
        if limit is None:
            limit = self.capturer.pool_limit(keep.key.device)
        while self.pool_bytes() > limit and len(self.programs) > 1:
            old = min((p for p in self.programs.values() if p is not keep),
                      key=lambda p: p.used)
            self._drop([old])
            self.evictions += 1

    def _drop(self, progs):
        # A replay still queued may read the graph and its pool.
        for d in {p.key.device for p in progs}:
            self.capturer.synchronize(d)
        for p in progs:
            del self.programs[p.key]
            self.capturer.destroy(p.graph)

    def clear(self):
        """Drop every captured program and forget the keys seen."""
        with self._lock:
            self._drop(list(self.programs.values()))
            self._seen.clear()

    def stats(self):
        """What the cache did: eager first calls, captures, replays, the
        programs held, evictions, the pools' bytes now, and a record a
        key."""
        return dict(
            eager=sum(s["eager"] for s in self.by_key.values()),
            captures=sum(s["captures"] for s in self.by_key.values()),
            replays=sum(s["replays"] for s in self.by_key.values()),
            programs=len(self.programs), evictions=self.evictions,
            pool_bytes=self.pool_bytes(),
            by_key=[dict(key=str(k), program=k.name, **s) for k, s in self.by_key.items()],
        )


_cache = ProgramCache()


def run(name, fn, inputs, static, device):
    """Program `name`, fn(*inputs) with these static arguments: from the
    process's cache where graphs_enabled(device), else eagerly."""
    if not graphs_enabled(device):
        return fn(*inputs)
    with span(_span_names(name)["key"]):
        key = program_key(name, inputs, static, device)
    return _cache.run(key, fn, inputs)


def clear_programs():
    """Drop every captured program and its pool (jax.clear_caches())."""
    _cache.clear()


def capturing() -> bool:
    """True while this thread captures a program (its calls run nothing)."""
    return _build.recording_active()


def replays() -> Counter:
    """Replays so far, by program name."""
    return _cache.replays


def stats() -> dict:
    """The process cache's ProgramCache.stats()."""
    return _cache.stats()
