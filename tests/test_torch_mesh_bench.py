"""The benchmark's mesh cell (benchmark/loops/mesh.py, benchmark/jxlbench/
ranks.py, benchmark/generators/panorama.py, benchmark/metrics/mesh.*) on
the CPU, its ranks over gloo:

(a) the loop with 2 ranks: warm and a short window; every rank served the
    same requests, and rank 0's bytes equal encode_image_device's and hold
    to the benchmark's golden model
(b) a rank that fails ends the run with an error, well inside the groups'
    timeouts
(c) the split of the cpus between the ranks: disjoint sets of one size
(d) the readers of the mesh's metrics on a made-up trace, and on one
    without the port's mesh spans (nothing to read)
(e) the panorama: chip_smoke.py's config-5 layout and size, distinct
    images a pool

Rank 0 runs in a process of its own (as benchmark/run.py does), which
starts the other ranks."""
import json
import os
import re
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from jxlbench import ranks as R  # noqa: E402
from jxlbench import spans as S  # noqa: E402
from jxlbench import spec  # noqa: E402
from jxlbench import trace as T  # noqa: E402
from jxlbench.inputs import make_pool  # noqa: E402

# A panorama of gradient512 cut to 256x512 (2 groups), 2 images a pool.
CONFIG = dict(name="pan-small", generator="panorama", image="testdata/gradient512.pfm",
              width=512, height=512, panorama=[256, 512], distance=1.0, tier="default",
              variants=dict(orientations=["flip_y"], gains=[0.8, 1.2], gain_jitter=0.02))
SEED = 2**31 + 4321

RANK0 = textwrap.dedent('''
    import functools, json, sys, types
    from jxlbench import drivers
    from jxlbench.inputs import make_pool
    from jxl_tiny_tpu_torch import encoder

    config, traffic, seed, seconds, out = json.loads(sys.argv[1])
    enc = types.SimpleNamespace(
        encode_image_device=functools.partial(encoder.encode_image_device, device="cpu"),
        encode_image_device_mesh=encoder.encode_image_device_mesh)
    pool = make_pool(".", config, traffic, seed)
    if traffic.get("break_children"):
        pool.source["config"] = dict(config, image="testdata/missing.pfm")
    loop = drivers.load(traffic)
    loop.warm(enc, pool, traffic, 1.0)
    window = loop.run(enc, pool, traffic, 1.0, seconds, pool.order())
    for k, r in enumerate(window.requests):
        with open(f"{out}/{k}.{r.idx}.jxl", "wb") as f:
            f.write(r.outputs[0])
''')


def _rank0(tmp_path, traffic, seconds=1.0, timeout=120):
    args = json.dumps([CONFIG, traffic, SEED, seconds, str(tmp_path)])
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", RANK0, args], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, REPO])))
    return out, time.monotonic() - t


def _traffic(**kw):
    with open(os.path.join(BENCH, "traffic", "u8.mesh4.json")) as f:
        return dict(json.load(f), ranks=2, device="cpu", **kw)


def test_mesh_loop_on_two_cpu_ranks(tmp_path):
    from jxl_tiny_tpu_torch import encoder
    from jxlbench.check import Checker

    out, _ = _rank0(tmp_path, _traffic())
    assert out.returncode == 0, out.stderr[-3000:]
    reports = json.loads(re.search(r"^mesh: (\[.*\])$", out.stderr, re.M).group(1))
    files = sorted(os.listdir(tmp_path), key=lambda f: int(f.split(".")[0]))
    pool = make_pool(REPO, CONFIG, _traffic(), SEED)
    warmed = 2 * len(pool.requests)
    assert [r["served"] for r in reports] == [warmed + len(files)] * 2
    assert files and all(r["cpus"] == reports[0]["cpus"] and not r["forbidden"]
                         for r in reports)
    seen = {}
    for f in files:
        idx = int(f.split(".")[1])
        data = (tmp_path / f).read_bytes()
        if idx not in seen:
            seen[idx] = encoder.encode_image_device(pool.requests[idx][0], 1.0, device="cpu")
        assert data == seen[idx], f
    idx = int(files[0].split(".")[1])
    with Checker(workers=1) as ch:
        got = ch.compare((tmp_path / files[0]).read_bytes(),
                         pool.reference_pixels(pool.requests[idx][0]), 1.0)
    assert got["groups"] == 2 and got["values_off"] == 0 and got["header_off"] == 0
    assert got["blocks_off"] == 0


def test_failing_rank_ends_the_run(tmp_path):
    """Rank 1 cannot make its pool and raises while rank 0 waits for it in
    the pools' check: rank 0 ends at once, with an error, no bytes out."""
    out, seconds = _rank0(tmp_path, _traffic(break_children=True), timeout=100)
    assert out.returncode != 0
    assert "rank 1 of 2 exited with code 1" in out.stderr, out.stderr[-3000:]
    assert seconds < 60 and not os.listdir(tmp_path)


@pytest.mark.parametrize("allowed, n, want", [
    (range(32), 4, [list(range(8 * r, 8 * r + 8)) for r in range(4)]),
    ([5, 1, 9, 3, 7], 2, [[1, 3], [5, 7]]),
    ({0, 1, 2, 3, 4, 5}, 4, [[0], [1], [2], [3]]),
    ([0, 1], 3, None),
])
def test_cpu_split(allowed, n, want):
    """Disjoint sets of one size, in order; fewer cpus than ranks raise."""
    if want is None:
        with pytest.raises(ValueError):
            R.split_cpus(allowed, n)
    else:
        assert R.split_cpus(allowed, n) == want


def _run(ops, ranges, megapixels=63.0, images=1, world=4):
    trace = T.Trace([T.DeviceOp(*o) for o in ops], (0.0, 10.0), sorted(ranges))
    work = dict(images=images, groups=960 * images, dc_groups=16 * images,
                stream_bytes=2_670_000 * images)
    fanned = [S.Span("mesh.fan_out", str(world), 0.9, 0.95, -1)] if world else []
    return types.SimpleNamespace(trace=trace, megapixels=megapixels, images=images,
                                 work=work, roofline=spec.roofline_modules(), spans=fanned)


def _readers():
    return {n: spec.load_module("metrics", n) for n in (
        "mesh.collectives_device_ms_per_mp", "mesh.collectives_roofline",
        "mesh.collectives_host_ms_per_mp", "mesh.programs_host_ms_per_mp",
        "mesh.rank_device_ms_per_mp")}


def test_mesh_readers_on_a_made_up_trace():
    nccl = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    ops = [(nccl, 1.0, 1.004, "nccl:all_gather"),
           ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 3.0, 3.002,
            "nccl:gather"),
           ("void aq_kernel<8>(float const*)", 1.1, 1.2, "mesh:program_a"),
           ("Memcpy DtoD (Device -> Device)", 1.3, 1.31, "nccl:all_gather"),
           ("void at::native::cat(int)", 1.4, 1.42, "mesh.all_gather"),
           ("Memcpy DtoD (Device -> Device)", 3.1, 3.15, "nccl:gather"),
           ("Memcpy HtoD (Pinned -> Device)", 0.5, 0.6, "ingest.copy")]
    ranges = [(1.0, 2.0, "mesh:program_a"), (1.2, 1.5, "mesh.all_gather"),
              (1.25, 1.3, "nccl:all_gather"), (2.0, 2.5, "mesh:program_b"),
              (2.1, 2.2, "mesh.all_gather"), (3.0, 3.2, "mesh.gather0")]
    got = {k: m.read(_run(ops, ranges)) for k, m in _readers().items()}
    assert got["mesh.collectives_device_ms_per_mp"] == pytest.approx(6.0 / 63)
    assert got["mesh.collectives_host_ms_per_mp"] == pytest.approx(600.0 / 63)
    assert got["mesh.programs_host_ms_per_mp"] == pytest.approx(1100.0 / 63)
    assert got["mesh.rank_device_ms_per_mp"] == pytest.approx(130.0 / 63)
    # rank 0: the maps, totals and sizes (3 x (240 x 24,712 + 488 x 8) B)
    # each way, 3/4 of the summed histograms, 3/4 of the codestream in
    least = 3 * (240 * 24712 + 488 * 8) + 3 * 65536 // 2 + 2_670_000 * 3 / 4
    assert got["mesh.collectives_roofline"] == pytest.approx(
        100.0 * least / 450e9 / 0.006)
    # Without the port's mesh spans (its parent): only the NCCL kernels read.
    bare = {k: m.read(_run([(o[0], o[1], o[2], "") for o in ops], []))
            for k, m in _readers().items()}
    assert bare["mesh.collectives_device_ms_per_mp"] == got["mesh.collectives_device_ms_per_mp"]
    assert bare["mesh.collectives_roofline"] == got["mesh.collectives_roofline"]
    for k in ("mesh.collectives_host_ms_per_mp", "mesh.programs_host_ms_per_mp",
              "mesh.rank_device_ms_per_mp"):
        assert bare[k] is None, k
    assert _readers()["mesh.collectives_device_ms_per_mp"].read(_run(ops[2:3], [])) is None
    assert _readers()["mesh.collectives_roofline"].read(_run(ops, ranges, world=None)) is None


def test_panorama_is_config_5s_and_the_pool_distinct():
    from test_torch_encode import _chip_smoke

    smoke = _chip_smoke()
    gen = spec.load_module("generators", "panorama")
    img = np.random.default_rng(3).random((3, 54, 96), np.float32)
    assert np.array_equal(gen.panorama(img, 200, 192), smoke.panorama(img, 200, 192))
    with open(os.path.join(BENCH, "configs", "panorama64-d1.json")) as f:
        assert json.load(f)["panorama"] == list(smoke.PANORAMA)
    with pytest.raises(ValueError):
        gen.panorama(img, 217, 192)
    pool = make_pool(REPO, dict(CONFIG, variants=dict(CONFIG["variants"], orientations=[
        "none", "flip_x", "flip_y", "rot180"])), _traffic(), 7)
    imgs = [r[0] for r in pool.requests]
    assert len(imgs) == 8 and all(i.shape == (3, 256, 512) and i.dtype == np.uint8
                                  for i in imgs)
    assert len({i.tobytes() for i in imgs}) == 8
    assert pool.source["seed"] == 7 and pool.source["config"]["generator"] == "panorama"
