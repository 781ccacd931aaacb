"""What the benchmark's tests share: a small cell driven on the CPU through
the harness's own code, with the card's side replaced."""
import argparse
import functools
import json
import os
import types

from jxlbench import main, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class HostOnly:
    """Stands in for main.Card on a host without a card: nothing to wait
    for, no device memory, a profiler of the CPU alone."""

    def synchronize(self):
        pass

    def peak_bytes(self):
        return 0

    def free(self):
        pass

    def name(self):
        return "cpu"

    def profile(self):
        import torch

        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def cpu_encoder(**overrides):
    """The encoder's three entry points on the CPU (device="cpu"), any of
    them replaced."""
    from jxl_tiny_tpu_torch import encoder

    ns = types.SimpleNamespace(
        encode_image_device=functools.partial(encoder.encode_image_device, device="cpu"),
        encode_batch_device=functools.partial(encoder.encode_batch_device, device="cpu"),
        encode_images_device=functools.partial(encoder.encode_images_device, device="cpu"))
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns


def small_cell(traffic, *, tile=None, batch=2, answers=1, limits=None, per_layer=()):
    """A cell on gradient512 (four groups) or on 512x512 tiles of photo8mp,
    with the benchmark's own limits unless given."""
    if tile:
        config = dict(name="tiles512", generator="photo_variants", image="testdata/photo8mp.pfm", width=3840,
                      height=2160, tile=[tile, tile], tile_rows=[0, 1000],
                      tile_cols=[0, 1500, 3000], distance=1.0, tier="default",
                      variants=dict(orientations=["none", "rot180"], gains=[0.7, 1.4],
                                    gain_jitter=0.02))
    else:
        config = dict(name="gradient512", generator="photo_variants", image="testdata/gradient512.pfm", width=512,
                      height=512, tile=None, distance=1.0, tier="default",
                      variants=dict(orientations=["none", "flip_x"], gains=[0.8, 1.2],
                                    gain_jitter=0.02))
    with open(os.path.join(spec.BENCH_DIR, "traffic", traffic + ".json")) as f:
        t = json.load(f)
    t["check"] = {"answers": answers}
    t["batch"] = batch
    if limits is None:
        with open(os.path.join(spec.BENCH_DIR, "limits", "photo8mp-d1.u8.single.json")) as f:
            limits = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        layers = [m for m in json.load(f)["per_layer"] if m["name"] in per_layer]
    e2e = [dict(name=n, unit=u) for n, u in (("mps", "MP/s"), ("bpp", "bit/px"),
                                            ("setup_s", "s"), ("latency_p95_ms", "ms"))]
    return spec.Cell("small", 1, config, t, limits, e2e, layers)


def run(cell, enc=None, seed=7, seconds=0.5, trace=0):
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=seconds, trace=trace)
    import time

    return main.run_cell(ROOT, cell, args, enc or cpu_encoder(), HostOnly(), time.perf_counter())
