"""Observability of the port: per-stage host-clock timers, the device time
of queued work (CUDA events), torch.profiler traces with the card's busy
share, and the megapixels/s report.

Counterpart of the JAX package's utils/profiling.py (StageTimer,
profile_trace, encode_report and `python -m ... input.pfm`). The port
queues its work without waiting, so a host clock only measures device
time when it stops after a synchronize: `StageTimer.stage(sync=...)` and
`StageTimer.wrap(sync=True)` wait for the device work behind a value;
`device_time` times the device alone; `profile_trace` replaces the XLA
trace with a Chrome trace of torch.profiler.

    python -m jxl_tiny_tpu_torch.utils.profiling input.pfm [-d D] [--trace] [--device cpu]

prints one JSON line (encode_report's report). Every number names its
device: `device`, and on the card `card` (name and power limit).
"""
import contextlib
import ctypes
import json
import os
import subprocess
import tempfile
import time

import torch


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
    """Accumulates named stage timings (host clock) across an encode.

        with timer.stage("analysis", sync=out): ...
        restore = timer.wrap(module, "function", sync=True)
    """

    def __init__(self):
        self.stages = {}

    def _add(self, name, seconds):
        self.stages[name] = self.stages.get(name, 0.0) + seconds

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

    def wrap(self, module, name, sync=False, label=None):
        """Replace module.<name> by a function that adds each call's time to
        stage `label` (default: name); with sync, the clock stops after the
        device work behind the call's result. Returns restore(), which puts
        the function back."""
        real = getattr(module, name)
        label = name if label is None else label

        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = real(*args, **kwargs)
            if sync:
                _sync(out)
            self._add(label, time.perf_counter() - t)
            return out

        setattr(module, name, timed)
        return lambda: setattr(module, name, real)

    def report(self):
        total = sum(self.stages.values())
        return {
            "total_s": round(total, 4),
            "stages_ms": {k: round(v * 1e3, 1) for k, v in self.stages.items()},
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


def busy_share(fn):
    """Run fn once under torch.profiler (CPU and CUDA activities). Returns
    dict(wall_ms, busy_ms, busy_share, top: the six kernels with the most
    device time as (name, ms, calls)), or None where the profiler
    records no device time. busy_ms sums the device-side entries (kernels,
    copies, fills), so work that overlaps on two streams counts twice. A
    measurement only: it never fails a run."""
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
    busy = sum(r[1] for r in rows)
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


def _nvml_power_limit_w(index):
    """The card's enforced power limit (W) through NVML, or None."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    handle, mw = ctypes.c_void_p(), ctypes.c_uint()
    if (nvml.nvmlInit_v2() != 0
            or nvml.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)) != 0
            or nvml.nvmlDeviceGetEnforcedPowerLimit(handle, ctypes.byref(mw)) != 0):
        return None
    return mw.value / 1000.0


def card_name(index=0):
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them; without nvidia-smi,
    torch's device name and NVML's enforced limit in the same form."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    limit = _nvml_power_limit_w(index)
    return (f"{torch.cuda.get_device_name(index)}, "
            + ("power limit unknown" if limit is None else f"{limit:.2f} W"))


def encode_report(img, distance=1.0, repeats=3, device=None, **kw):
    """Timed encode_image_device of one [3, H, W] image: one warm-up encode,
    then `repeats` timed ones (host clock; each returns bytes, so each ends
    with its work done). Returns (bytes, report): megapixels, bytes, bpp,
    times_s, mps_best and device; on the card also, for DeviceEncodeJob's
    two programs at the final capacities, program_a_ms and program_b_ms
    (device_span's ms: CUDA events), program_a_queue_ms and
    program_b_queue_ms (the host's time to queue one call), and
    program_ms_are, which says what the two ms are: "device time" where the
    spin outlasted the host's queueing, else "device span with host waits";
    and card (name and power limit). The one-pass static tier runs one
    program: it reports program_b_* alone. kw goes to encode_image_device
    (upload_dtype, config, kernels, ...)."""
    from ..encoder import DeviceEncodeJob, encode_image_device
    from ..transfer import resolve_device

    dev = resolve_device(device)
    mp = img.shape[1] * img.shape[2] / 1e6
    data = encode_image_device(img, distance, device=dev, **kw)  # warm-up
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        data = encode_image_device(img, distance, device=dev, **kw)
        times.append(time.perf_counter() - t)
    rep = {
        "megapixels": round(mp, 3),
        "bytes": len(data),
        "bpp": round(8 * len(data) / (mp * 1e6), 4),
        "times_s": [round(t, 4) for t in times],
        "mps_best": round(mp / min(times), 3),
        "device": str(dev),
    }
    if dev.type == "cuda":
        job = DeviceEncodeJob([img], distance, device=dev, **kw)
        if job.result() != [data]:
            raise RuntimeError("encode_report: the timed job's bytes differ")
        progs = {"b": job._dispatch_b}
        if not job._static:
            progs = {"a": lambda: job._run_a(job.cap), **progs}
        all_hidden = True
        for k, fn in progs.items():
            ms, hidden, queue_ms = device_span(fn, 3, 1)
            rep[f"program_{k}_ms"] = round(ms, 4)
            rep[f"program_{k}_queue_ms"] = round(queue_ms, 4)
            all_hidden &= hidden
        rep["program_ms_are"] = "device time" if all_hidden else "device span with host waits"
        rep["card"] = card_name(dev.index or 0)
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
