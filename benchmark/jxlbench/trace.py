"""The device's side of a traced run, from torch.profiler's trace.

The profiler runs over the whole traced window. Its Chrome trace is
written under $TMPDIR, read back and deleted. From it come the device's
operations (kernels, copies, fills: name, stream, start, end), each tied
through its correlation id to the runtime call that launched it, and that
call to the innermost host range open on its thread when it ran (the
benchmark's spans are such ranges). So every device operation knows which
span launched it: a graph replay's kernels share the correlation id of
the graph launch inside `programs.run`.
"""
import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # seconds on the trace's clock
    end: float
    launcher: str  # the innermost host range around its launch, "" if none


@dataclasses.dataclass
class Trace:
    ops: list
    window: tuple  # (start, end) of the "window" range
    ranges: list  # (start, end, name) of the host ranges on the main thread

    def in_window(self):
        lo, hi = self.window
        return [o for o in self.ops if o.end > lo and o.start < hi]


def kernel_name(raw: str) -> str:
    """A kernel's identifier without its scope, return type, template or
    parameters: 'void ns::aq_kernel<8>(float const*, ...)' -> 'aq_kernel';
    a mangled '_Z9aq_kernelPKf...' -> 'aq_kernel'. Copies and fills keep
    their whole name ('Memcpy HtoD (Pinned -> Device)')."""
    if raw.startswith(("Memcpy", "Memset")):
        return raw
    m = re.match(r"_Z(\d+)", raw)
    if m:
        return raw[m.end(): m.end() + int(m.group(1))]
    head = re.split(r"[<(]", raw.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    return head.split()[-1].split("::")[-1] if head.split() else raw


def short_name(raw: str, limit=120) -> str:
    """A device operation's name for the breakdown: without its return
    type and parameters, at most `limit` characters."""
    if raw.startswith(("Memcpy", "Memset")):
        return raw
    name = raw[5:] if raw.startswith("void ") else raw
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and not name.startswith("(anonymous", i):
            name = name[:i]
            break
    return name[:limit]


def profile():
    """A torch.profiler over the CPU and the card, not yet started."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def read(prof) -> Trace:
    """Export prof's trace under $TMPDIR, parse it and delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return parse(data.get("traceEvents", data) if isinstance(data, dict) else data)


def parse(events) -> Trace:
    """Chrome-trace events -> Trace (times in seconds)."""
    runtime = {}  # correlation -> (tid, ts)
    ranges_by_tid = {}
    window = None
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((e.get("name", ""), ts, ts + dur, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                runtime[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "user_annotation":
            if e.get("name") == "window":
                window = (ts, ts + dur)
            ranges_by_tid.setdefault(e.get("tid"), []).append((ts, ts + dur, e["name"]))
    for rs in ranges_by_tid.values():
        rs.sort()
    queries = {}  # tid -> [(launch time, op index)]
    for k, (_, _, _, corr) in enumerate(device):
        if corr in runtime:
            tid, ts = runtime[corr]
            queries.setdefault(tid, []).append((ts, k))
    launcher = [""] * len(device)
    for tid, qs in queries.items():
        for k, name in zip((k for _, k in sorted(qs)),
                           innermost(ranges_by_tid.get(tid, []), sorted(t for t, _ in qs))):
            launcher[k] = name
    ops = [DeviceOp(name, s, t, launcher[k]) for k, (name, s, t, _) in enumerate(device)]
    if window is None:
        raise ValueError("the trace has no 'window' range")
    main = max(ranges_by_tid.values(), key=lambda rs: any(r[2] == "window" for r in rs))
    return Trace(ops, window, main)


def innermost(ranges, times):
    """For each of the sorted times, the name of the innermost of the
    (nested, sorted by start) ranges open then, the "window" range aside;
    "" where none is."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        inner = [r for r in stack if r[2] != "window" and r[0] <= t < r[1]]
        out.append(inner[-1][2] if inner else "")
    return out


def device_seconds(ops, launcher_prefix) -> float:
    """Summed time of the device operations launched under host ranges
    whose name starts with launcher_prefix."""
    return sum(o.end - o.start for o in ops if o.launcher.startswith(launcher_prefix))
