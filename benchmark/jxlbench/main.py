"""One run of one cell: set up, warm, measure a window, check the output,
print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics (spans wrapped around the program, torch.profiler over the
window). Both check the output the same way. The numbers compared are the
last lines on standard error and the "check" key of the result, each with
its limit; `correct` is true when every one is within it.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

from . import drivers, spans as S, spec, stats, trace as T
from .inputs import make_pool, sample

FORBIDDEN = ("jax", "jaxlib", "flax", "jxl_tiny_tpu")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs(root):
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Card:
    """The CUDA card's side of a run (tests hand run_cell a stand-in)."""

    def __init__(self):
        import torch

        self.torch = torch

    def synchronize(self):
        self.torch.cuda.synchronize()

    def peak_bytes(self):
        return self.torch.cuda.max_memory_reserved()

    def free(self):
        self.torch.cuda.empty_cache()

    def name(self):
        return self.torch.cuda.get_device_name(0)

    def profile(self):
        return T.profile()


def main(argv, root, t_start):
    args = parse_args(argv)
    set_cache_dirs(root)
    cell = spec.load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from jxl_tiny_tpu_torch import encoder

    log(f"imports and CUDA {time.perf_counter() - t_start:.3f} s")
    result = run_cell(root, cell, args, encoder, Card(), t_start)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may load: {', '.join(bad)}")
        return 3
    for name, c in result["check"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def run_cell(root, cell, args, enc, card, t_start) -> dict:
    """Set-up, warm-up, the window and the check of one run, through the
    encoder module `enc`'s entry points; the result's dict."""
    import torch
    from jxl_tiny_tpu_torch.ops import programs

    cfg, traffic = cell.config, cell.traffic
    if cfg.get("tier", "default") != "default":
        raise ValueError("only the default tier is driven")
    distance = cfg["distance"]
    pool = make_pool(root, cfg, traffic, args.seed, cell.bench_dir)
    loop = drivers.load(traffic, cell.bench_dir)
    t_pool = time.perf_counter()
    loop.warm(enc, pool, traffic, distance)
    card.synchronize()
    t_warm = time.perf_counter()

    rec, prof = None, None
    if args.trace:
        readers = {m["name"]: spec.load_module("metrics", m["name"], cell.bench_dir)
                   for m in cell.per_layer}
        wanted = {}
        for r in readers.values():
            wanted.update(getattr(r, "SPANS", {}))
        rec = S.Recorder()
        rec.install(wanted)
        prof = card.profile()
        prof.start()
    stats_before = programs.stats()
    order = pool.order()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if rec is not None:
        rec.active = True
        with torch.profiler.record_function("window"):
            window = loop.run(enc, pool, traffic, distance, args.seconds, order)
            card.synchronize()
        rec.active = False
    else:
        window = loop.run(enc, pool, traffic, distance, args.seconds, order)
    stats_after = programs.stats()
    trace = None
    if prof is not None:
        prof.stop()
        rec.uninstall()
        t = time.perf_counter()
        trace = T.read(prof)
        log(f"trace: {len(trace.ops)} device operations, read in "
            f"{time.perf_counter() - t:.1f} s")
    peak = card.peak_bytes()
    keys = stats_after.get("by_key", [])
    eager_ms = sum(k["warm_ms"] or 0 for k in keys)
    capture_ms = sum(sum(k["capture_ms"]) for k in keys)
    log(f"set-up {setup_s:.3f} s (to the pool {t_pool - t_start:.3f}, warm "
        f"{t_warm - t_pool:.3f}, of which the keys' eager first calls {eager_ms / 1e3:.3f} "
        f"and captures {capture_ms / 1e3:.3f}); "
        f"window {window.end - window.start:.3f} s, {len(window.requests)} requests; "
        f"peak reserved {peak} B; programs "
        f"{json.dumps({k: v for k, v in stats_after.items() if k != 'by_key'})}")
    programs.clear_programs()
    card.free()

    checks, work = check(window, pool, traffic, cell.limits, distance, args.seed)
    ok_reqs = [r for r in window.requests if r.ok]
    images = [im for r in ok_reqs for im in pool.requests[r.idx]]
    pixels = sum(im.shape[1] * im.shape[2] for im in images)
    nbytes = sum(len(d) for r in ok_reqs for d in r.outputs)
    attempted = sum(len(pool.requests[r.idx]) for r in window.requests)
    metrics = {}
    device = dict(platform="gpu", kind=card.name(), count=cell.chips,
                  memory_peak_bytes=int(peak))
    result = dict(correct=all(v <= lim for _, v, lim in checks), attempted=attempted,
                  failed=attempted - len(images))
    if not args.trace:
        values = dict(
            mps=stats.rate(pixels / 1e6, window.end - window.start),
            bpp=stats.bits_per_pixel(nbytes, pixels) if pixels else float("nan"),
            setup_s=setup_s,
            latency_p95_ms=stats.percentile([r.latency for r in window.requests], 95) * 1e3,
        )
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        run = Run(rec.spans, stats_before, stats_after, trace, work, pixels)
        result["breakdown"] = per_layer(run, readers, cell.per_layer, metrics)
        lo, hi = trace.window
        device["busy_s"] = stats.busy([(o.start, o.end) for o in trace.ops], lo, hi)
        device["window_s"] = hi - lo
    result["metrics"] = metrics
    result["device"] = device
    result["check"] = {name: dict(value=v, limit=lim) for name, v, lim in checks}
    return result


class Run:
    """What a per-layer metric's reader reads (benchmark/metrics/*.py)."""

    def __init__(self, spans, stats_before, stats_after, trace, work, pixels):
        self.spans = spans
        self.stats_before, self.stats_after = stats_before, stats_after
        self.trace = trace
        self.work = work
        self.megapixels = pixels / 1e6
        self.images = work["images"]
        self.peak_bytes_per_s = PEAK_BYTES_PER_S
        self.roofline = spec.roofline_modules()


def per_layer(run, readers, entries, metrics):
    """Each per-layer metric that its reader finds; the breakdown."""
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    lo, hi = run.trace.window
    ops = run.trace.in_window()
    by_name = {}
    for o in ops:
        k = T.short_name(o.name)
        by_name[k] = by_name.get(k, 0.0) + (min(o.end, hi) - max(o.start, lo))
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]:
        log(f"device time {v:.6f} s: {k} (kernel {T.kernel_name(k)})")
    idle = {}
    gaps = stats.gaps([(o.start, o.end) for o in ops], lo, hi)
    for (s, e), name in zip(gaps, T.innermost(run.trace.ranges, [(s + e) / 2 for s, e in gaps])):
        key = name or "outside every span"
        idle[key] = idle.get(key, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]])


def check(window, pool, traffic, limits, distance, seed):
    """The numbers compared, each (name, value, limit), and the traced
    window's work for the rooflines."""
    from .check import Checker, add_counts, summarize

    failed = [r for r in window.requests if not r.ok]
    for r in failed[:3]:
        log(f"request {r.idx} failed: {r.error}")
    done = [((r.idx, k), d) for r in window.requests if r.ok for k, d in enumerate(r.outputs)]
    short = sum(1 for r in window.requests if r.ok and len(r.outputs) != len(pool.requests[r.idx]))
    # Repeats of one input give the same bytes; distinct inputs other bytes.
    first, answers, differ = {}, {}, 0
    for key, d in done:
        h = hashlib.sha256(d).digest()
        differ += first.setdefault(key, h) != h
        answers.setdefault(key, d)
    shared = len(first) - len(set(first.values()))
    pick = sample(first, seed, traffic["check"]["answers"])
    total, unparsed = {}, 0
    t = time.perf_counter()
    with Checker() as ch:
        for key in pick:
            out = ch.compare(answers[key], pool.reference_pixels(pool.requests[key[0]][key[1]]),
                             distance)
            log(f"reference: request {key[0]} image {key[1]}: {json.dumps(out)}")
            if "error" in out:
                unparsed += 1
                continue
            add_counts(total, out)
    log(f"reference: {len(pick)} image(s) compared in {time.perf_counter() - t:.1f} s")
    total["sample_bytes"] = sum(len(answers[key]) for key in pick)
    nums = summarize(total)
    checks = [
        ("failed", len(failed), 0),
        ("short", short, 0),
        ("repeats_differ", differ, 0),
        ("inputs_share_bytes", shared, 0),
        ("unparsed", unparsed, 0),
        ("header_off", total.get("header_off", 0), 0),
        ("not_compared", 0 if total.get("groups") else 1, 0),
    ] + [(k, v, limits[k]) for k, v in nums.items()]
    return checks, window_work(window, pool, total)


def window_work(window, pool, ref):
    """The window's work, for the rooflines: counted from the inputs'
    shapes and the outputs' bytes; the AC tokens are the golden model's
    count on the images it compared, scaled by the window's codestream
    bytes over theirs."""
    images = [im for r in window.requests if r.ok for im in pool.requests[r.idx]]
    work = dict(images=len(images), pixels=0, groups=0, dc_groups=0, pixel_bytes=0,
                stream_bytes=sum(len(d) for r in window.requests if r.ok for d in r.outputs))
    for im in images:
        _, h, w = im.shape
        work["pixels"] += h * w
        work["groups"] += (-(-h // 256)) * (-(-w // 256))
        work["dc_groups"] += (-(-h // 2048)) * (-(-w // 2048))
        size = 1 if im.dtype.itemsize == 1 else 2 if pool.upload == "float16" else 4
        work["pixel_bytes"] += 3 * h * w * size
    work["tokens"] = (ref["tokens"] * work["stream_bytes"] / ref["sample_bytes"]
                      if ref.get("tokens") and ref.get("sample_bytes") else None)
    return work
