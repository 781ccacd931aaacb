"""Observability of the port: its spans (named host stages inside the
encoder, on torch.profiler's clock), per-stage host-clock timers, the device
time of queued work (CUDA events), torch.profiler traces with the card's
busy share, and the megapixels/s report.

Counterpart of the JAX package's utils/profiling.py (StageTimer,
profile_trace, encode_report and `python -m ... input.pfm`). The port
queues its work without waiting, so a host clock only measures device
time when it stops after a synchronize: `StageTimer.stage(sync=...)` waits
for the device work behind a value; `device_time` times the device alone;
`profile_trace` replaces the XLA trace with a Chrome trace of
torch.profiler.

Spans: the encoder marks its stages with `span("<layer>.<stage>")` (a
`:<label>` suffix where one stage has kinds, such as the rule that made
program B run again). A span is off unless a torch.profiler is recording
or a StageTimer collects (`with timer.collect():`); off, it is one flag
check and a shared null context. On, it is a `record_function` range of
the profiler's trace, on the clock of the device operations, so that each
idle stretch of the card falls under the host stage the host was in, and
the collecting timers add its host seconds and one call under its name.
Spans mark stages, not the items of a loop, and their names hold no
request's identity. The spans, by layer (the module that opens them):

  ingest (transfer.upload_pixels, on the card): ingest.pin, ingest.convert,
      ingest.copy (inside it ingest.round, float32 pixels rounded to
      float16 on the card); transfer.Fetch.numpy: transfer.wait
  programs (ops/programs.run, ProgramCache.run): programs:<name>.key,
      .eager, .capture, .copy_in, .replay, .clone_out
  host codes (encoder.DeviceEncodeJob.pack): codes.read, codes.build,
      codes.upload, program_a.cap_retry
  the mesh (DeviceEncodeJob on a parallel.sharding.Mesh): mesh:program_a,
      mesh:program_b (the programs, run eagerly); inside them and in the
      gather of the section words (parallel.sharding.Mesh): mesh.psum,
      mesh.all_gather, mesh.exchange, mesh.gather0
  program B's retries (DeviceEncodeJob._fetch_sections):
      program_b.regrow:<rule>, the rule being ow, ow_dc, compact_ac or
      compact_dc
  assembly: assembly.grow (the section plan's checks), assembly.sections
      (section words read, a byte view a section), assembly.globals (their
      bits and their one pack; inside it assembly.globals.prefix, the DC
      global's frame-invariant bits, built once a num_dc_groups),
      assembly.toc (headers and TOC; inside it
      assembly.merge, a one-group frame's four sections merged at the bit
      level), assembly.bytes (the one copy of every section into the
      codestream) (encoder.assemble_codestream)

    python -m jxl_tiny_tpu_torch.utils.profiling input.pfm [-d D] [--trace] [--device cpu]

prints one JSON line (encode_report's report). Every number names its
device: `device`, and on the card `card` (its name).
"""
import contextlib
import json
import os
import statistics
import tempfile
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL_SPAN = contextlib.nullcontext()
_collectors = []  # the StageTimers collecting now (StageTimer.collect)


class _Span:
    """An open span: a record_function range where a profiler records,
    and its host seconds for the collecting timers."""

    __slots__ = ("name", "range", "timers", "t0")

    def __init__(self, name, profiled, timers):
        self.name, self.timers = name, timers
        self.range = torch.profiler.record_function(name) if profiled else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        for timer in self.timers:
            timer._add(self.name, seconds)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name):
    """The span `name` around a block (`with span("assembly.toc"): ...`):
    the shared null context unless a torch.profiler records or a
    StageTimer collects (see the module docstring)."""
    profiled = _autograd_profiler._is_profiler_enabled
    if not (profiled or _collectors):
        return _NULL_SPAN
    return _Span(name, profiled, tuple(_collectors))


def _sync(x):
    """Wait for the device work behind x: a tensor, a list / tuple / dict
    of them (nested), or a torch.cuda.Event. CPU values do not wait."""
    if isinstance(x, torch.cuda.Event):
        x.synchronize()
        return
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)

    walk(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates named stage timings (host clock) and their calls.

        with timer.stage("analysis", sync=out): ...
        with timer.collect(): encode_image_device(img)   # the port's spans

    Inside collect() the port's spans are on, and each adds its host
    seconds and one call under its name; a span inside another counts in
    both. Spans of every thread count while a timer collects."""

    def __init__(self):
        self.stages = {}
        self.calls = {}

    def _add(self, name, seconds):
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name, sync=None):
        """Time the block; before the clock stops, wait for the device work
        behind `sync` (see _sync)."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self._add(name, time.perf_counter() - t)

    @contextlib.contextmanager
    def collect(self):
        """Turn the port's spans on for the block and gather them here."""
        _collectors.append(self)
        try:
            yield self
        finally:
            _collectors.remove(self)

    def report(self):
        total = sum(self.stages.values())
        return {
            "total_s": round(total, 4),
            "stages_ms": {k: round(v * 1e3, 3) for k, v in self.stages.items()},
            "stage_calls": dict(self.calls),
        }


_cycles_per_ms = None


def _spin_cycles_per_ms():
    """Clock cycles torch.cuda._sleep spins a millisecond on this card
    (measured once, with CUDA events)."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # warm
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 20_000_000 / a.elapsed_time(b)
    return _cycles_per_ms


def device_span(fn, reps=5, warm=2):
    """Device time of the work one call of fn queues on the current CUDA
    stream: (ms, hidden, queue_ms).

    CUDA events around `reps` calls queued behind a spin kernel. The spin
    is sized to the host time of one call (queue_ms: fn's own host time,
    its device work not waited for), so that the host has queued every
    call before the first starts and its time stays out of the events'
    span: a host-bound program is timed on the device too. `hidden` says
    whether the spin outlasted the queueing. If it did not, the run is
    made again with one call behind a longer spin (a program of many
    launches may fill the card's launch queue, which blocks the host until
    the spin ends). A fn that waits for the card itself (a collective
    staged through the host) cannot be hidden: its ms is then the events'
    span a call, host waits included, and `hidden` is False. Needs a card."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    queue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    rate = _spin_cycles_per_ms()
    spin_ms = 1.0 + 2.0 * reps * queue_ms
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for _ in range(2):
        t = time.perf_counter()
        s.record()
        torch.cuda._sleep(int(spin_ms * rate))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        hidden = s.elapsed_time(a) > queued
        if hidden:
            break
        spin_ms, reps = 2.0 * max(spin_ms, queued), 1
    return a.elapsed_time(b) / reps, hidden, queue_ms


def device_time(fn, reps=5, warm=2):
    """Device time (ms) of the work one call of fn queues: device_span's
    ms (see there)."""
    return device_span(fn, reps, warm)[0]


def union_ms(intervals):
    """The time (in the intervals' unit) that at least one of the
    (start, end) intervals covers: overlapping streams count once."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def busy_share(fn):
    """Run fn once under torch.profiler (CPU and CUDA activities). Returns
    dict(wall_ms, busy_ms, busy_share, top: the six kernels with the most
    device time as (name, ms, calls)), or None where the profiler
    records no device time. busy_ms is the union of the device-side
    entries' intervals (kernels, copies, fills): work that overlaps on two
    streams counts once. A measurement only: it never fails a run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # Device-side entries only: an operator's own entry carries its
    # kernels' time again.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    busy = union_ms((e.time_range.start / 1e3, e.time_range.end / 1e3) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                top=[(k[:60], round(ms, 4), n) for k, ms, n in rows[:6]])


@contextlib.contextmanager
def profile_trace(logdir=None):
    """torch.profiler trace (CPU and, with a card, CUDA activities) around a
    block, written as a Chrome trace to logdir/trace.json (open it in
    chrome://tracing or Perfetto). logdir defaults to jxl_torch_trace in the
    temporary directory ($TMPDIR). Yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "jxl_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def encode_report(img, distance=1.0, repeats=3, device=None, **kw):
    """Timed encode_image_device of one [3, H, W] image: one warm-up encode
    (two where the programs run from the compiled-program cache: the first
    call of a key runs eagerly, the second captures it), then `repeats`
    timed ones (host clock; each returns bytes, so each ends
    with its work done). Returns (bytes, report): megapixels, bytes, bpp,
    times_s, mps_median (over the timed encodes), device, and stages_ms and
    stage_calls: the port's spans in the timed encodes (StageTimer.collect;
    host ms and calls by name, summed over the encodes); on the card also, for DeviceEncodeJob's
    two programs at the final capacities, program_a_ms and program_b_ms
    (device_span's ms: CUDA events), program_a_queue_ms and
    program_b_queue_ms (the host's time to queue one call), and
    program_ms_are, which says what the two ms are: "device time" where the
    spin outlasted the host's queueing, else "device span with host waits";
    programs_run_as: "graph replays" where the programs run from the
    compiled-program cache (ops/programs), else "eager"; `eager`: the same
    five figures with the programs run op by op (ops/programs.eager());
    `programs`: the record of each program key the timed encodes replayed
    (its first call's ms, its captures and their ms, its pool bytes, its
    replays) and pool_bytes, the bytes every captured program's pool holds
    now; and card (its name). The one-pass static tier runs one program: it reports
    program_b_* alone. kw goes to encode_image_device (upload_dtype,
    config, kernels, ...)."""
    from ..encoder import DeviceEncodeJob, encode_image_device
    from ..ops import programs
    from ..transfer import resolve_device

    dev = resolve_device(device)
    mp = img.shape[1] * img.shape[2] / 1e6
    for _ in range(2 if programs.graphs_enabled(dev) else 1):  # warm-up
        data = encode_image_device(img, distance, device=dev, **kw)
    replays0 = {e["key"]: e["replays"] for e in programs.stats()["by_key"]}
    times, timer = [], StageTimer()
    with timer.collect():
        for _ in range(repeats):
            t = time.perf_counter()
            data = encode_image_device(img, distance, device=dev, **kw)
            times.append(time.perf_counter() - t)
    stages = timer.report()
    rep = {
        "megapixels": round(mp, 3),
        "bytes": len(data),
        "bpp": round(8 * len(data) / (mp * 1e6), 4),
        "times_s": [round(t, 4) for t in times],
        "mps_median": round(mp / statistics.median(times), 3),
        "device": str(dev),
        "stages_ms": stages["stages_ms"],
        "stage_calls": stages["stage_calls"],
    }
    if dev.type == "cuda":
        job = DeviceEncodeJob([img], distance, device=dev, **kw)
        if job.result() != [data]:
            raise RuntimeError("encode_report: the timed job's bytes differ")
        progs = {"b": job._dispatch_b}
        if not job._static:
            progs = {"a": lambda: job._run_a(job.cap), **progs}
        rep["programs_run_as"] = "graph replays" if programs.graphs_enabled(dev) else "eager"
        rep["eager"] = {}
        for out, mode in ((rep, contextlib.nullcontext()), (rep["eager"], programs.eager())):
            all_hidden = True
            with mode:
                for k, fn in progs.items():
                    ms, hidden, queue_ms = device_span(fn, 3, 1)
                    out[f"program_{k}_ms"] = round(ms, 4)
                    out[f"program_{k}_queue_ms"] = round(queue_ms, 4)
                    all_hidden &= hidden
            out["program_ms_are"] = ("device time" if all_hidden
                                     else "device span with host waits")
        st = programs.stats()
        rep["programs"] = [e for e in st["by_key"] if e["replays"] > replays0.get(e["key"], 0)]
        rep["pool_bytes"] = st["pool_bytes"]
        rep["card"] = torch.cuda.get_device_name(dev)
    return data, rep


def main(argv=None):
    import argparse

    from ..io.pfm import read_pfm

    p = argparse.ArgumentParser(prog="jxl_tiny_tpu_torch.utils.profiling")
    p.add_argument("input")
    p.add_argument("-d", "--distance", type=float, default=1.0)
    p.add_argument("--trace", action="store_true",
                   help="write a torch.profiler Chrome trace of one timed encode to "
                   "$TMPDIR/jxl_torch_trace/trace.json")
    p.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' to run there")
    args = p.parse_args(argv)
    img = read_pfm(args.input)
    if args.trace:
        with profile_trace() as d:
            _, rep = encode_report(img, args.distance, repeats=1, device=args.device)
        rep["trace"] = os.path.join(d, "trace.json")
    else:
        _, rep = encode_report(img, args.distance, device=args.device)
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
