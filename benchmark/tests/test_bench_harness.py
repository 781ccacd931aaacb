"""CPU tests of the benchmark's harness: the seeded inputs, the arithmetic
of the metrics, the data-driven lookup of cells, mixes and metrics, which
modules a run loads, and a small cell driven end to end on the CPU."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import helpers as H
from jxlbench import drivers, inputs, main, spans, spec, stats, trace

BENCH = spec.BENCH_DIR


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _traffic(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_tiles():
    cfg = dict(_config("tiles1024-d1"), tile=[256, 256], tile_rows=[0, 512],
               tile_cols=[0, 256, 1024, 3000])
    return cfg, dict(_traffic("u8.batch64"), batch=12)


def test_generator_repeats_exactly(small_tiles):
    cfg, traffic = small_tiles
    a = inputs.make_pool(H.ROOT, cfg, traffic, 2**31 + 12345)
    b = inputs.make_pool(H.ROOT, cfg, traffic, 2**31 + 12345)
    c = inputs.make_pool(H.ROOT, cfg, traffic, 77)
    assert len(a.requests) == len(b.requests) == len(c.requests) == 2
    for ra, rb, rc in zip(a.requests, b.requests, c.requests):
        assert len(ra) == len(rc) == 12
        for x, y, z in zip(ra, rb, rc):
            assert x.dtype == np.uint8 and x.shape == (3, 256, 256) == z.shape
            np.testing.assert_array_equal(x, y)
    # Another seed: other pixels (the gains' jitter), the same sizes.
    assert any(not np.array_equal(x, z) for x, z in zip(a.requests[0], c.requests[0]))
    oa, ob = a.order(), b.order()
    seq = [next(oa) for _ in range(40)]
    assert seq == [next(ob) for _ in range(40)]
    assert all(p != q for p, q in zip(seq, seq[1:]))
    assert sorted(seq[:2]) == [0, 1]


def test_photo_pool_is_the_configured_mix():
    cfg = _config("photo8mp-d1")
    pool = inputs.make_pool(H.ROOT, cfg, _traffic("f32.single"), 5)
    assert len(pool.requests) == 8
    assert all(r[0].shape == (3, 2160, 3840) and r[0].dtype == np.float32
               for r in pool.requests)
    # The flips of one gain hold the same pixels in another order.
    np.testing.assert_array_equal(pool.requests[1][0], pool.requests[0][0][:, :, ::-1])
    ref = pool.reference_pixels(pool.requests[0][0])
    np.testing.assert_array_equal(ref, pool.requests[0][0].astype(np.float16).astype(np.float32))
    assert 0.98 < pool.gains[0] / 0.7071 < 1.02


def test_rate_tail_and_bits_per_pixel():
    assert stats.rate(50.0, 4.0) == 12.5
    lat = [0.010 * k for k in range(1, 101)]
    assert stats.percentile(lat, 95) == pytest.approx(0.95)
    assert stats.percentile(lat + [float("inf")], 95) == pytest.approx(0.96)
    # A failed request is in the tail, however few there are.
    assert stats.percentile([0.1] * 19 + [float("inf")], 100) == float("inf")
    assert stats.bits_per_pixel(1000, 8000) == 1.0


def test_idle_share_is_the_union_of_overlapping_streams():
    ops = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (6.0, 7.0), (6.5, 6.6)]
    assert stats.busy(ops, 0.0, 10.0) == pytest.approx(5.0)
    assert stats.gaps(ops, 0.0, 10.0) == [(4.0, 6.0), (7.0, 10.0)]
    tr = trace.Trace([trace.DeviceOp("k", s, e, "") for s, e in ops], (0.0, 10.0), [])
    reader = spec.load_module("metrics", "device.idle_share")
    run = type("R", (), {"trace": tr})()
    assert reader.read(run) == pytest.approx(50.0)


def test_trace_ties_each_operation_to_its_launching_span():
    ev = [
        dict(ph="X", cat="user_annotation", name="window", ts=0, dur=100, tid=1),
        dict(ph="X", cat="user_annotation", name="programs:pack_batch_sections", ts=10,
             dur=20, tid=1),
        dict(ph="X", cat="user_annotation", name="pack", ts=5, dur=40, tid=1),
        dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=12, dur=1, tid=1,
             args=dict(correlation=7)),
        dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=40, dur=1, tid=1,
             args=dict(correlation=8)),
        dict(ph="X", cat="kernel", name="void copy_sections_kernel<256>(int const*)", ts=20,
             dur=3, tid=99, args=dict(correlation=7)),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pinned)", ts=41, dur=2,
             tid=98, args=dict(correlation=8)),
    ]
    tr = trace.parse(ev)
    assert [(trace.kernel_name(o.name), o.launcher) for o in tr.ops] == [
        ("copy_sections_kernel", "programs:pack_batch_sections"),
        ("Memcpy DtoH (Device -> Pinned)", "pack")]
    assert trace.device_seconds(tr.ops, "programs:pack") == pytest.approx(3e-6)
    assert tr.window == pytest.approx((0.0, 1e-4))


def test_span_self_time_leaves_out_named_children():
    S = spans.Span
    rec = [S("result", "", 0.0, 10.0, -1), S("wait", "", 1.0, 3.0, 0),
           S("programs", "b", 4.0, 5.0, 0), S("wait", "", 4.5, 4.8, 2),
           S("other", "", 6.0, 7.0, 0)]
    assert spans.exclusive(rec, "result", {"wait", "programs"}) == pytest.approx(7.0)
    assert spans.total(rec, "wait") == pytest.approx(2.3)
    assert spans.count(rec, "programs", "b") == 1


NEW_GENERATOR = '''
import numpy as np

from jxlbench.inputs import rng_for


class Pool:
    """Two flat grey images a run, their level from the seed."""

    upload = None

    def __init__(self, root, config, traffic, seed):
        level = rng_for(seed, 1).integers(60, 200)
        self.requests = [[np.full((3, config["height"], config["width"]), level + k, np.uint8)]
                         for k in range(2)]

    def order(self):
        while True:
            yield from range(len(self.requests))

    def reference_pixels(self, img):
        return img.astype(np.float32) / 255
'''

NEW_LOOP = '''
from jxlbench.drivers import Request, Window


def warm(enc, pool, traffic, distance):
    pass


def run(enc, pool, traffic, distance, seconds, order, clock=None):
    reqs = []
    for k in range(traffic["requests"]):
        idx = next(order)
        reqs.append(Request(idx, float(k), float(k) + 0.5,
                            [enc.encode_image_device(pool.requests[idx][0], distance)]))
    return Window(0.0, reqs[-1].end, reqs)
'''


def test_harness_finds_a_cell_mix_config_and_metric_added_as_files(tmp_path):
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics", "generators", "loops"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "new-cfg.json").write_text(json.dumps(dict(
        _config("photo8mp-d1"), name="new-cfg", generator="grey", width=64, height=48)))
    (bench / "traffic" / "u8.new.json").write_text(json.dumps(dict(
        _traffic("u8.single"), loop="counted", requests=3)))
    (bench / "limits" / "new-cfg.u8.new.json").write_text(json.dumps(dict(values_off=0)))
    (bench / "metrics" / "new.metric.py").write_text(textwrap.dedent('''
        SPANS = {"ingest": "jxl_tiny_tpu_torch.encoder:upload_pixels"}

        def read(run):
            return 42.0
    '''))
    (bench / "generators" / "grey.py").write_text(NEW_GENERATOR)
    (bench / "loops" / "counted.py").write_text(NEW_LOOP)
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="new-cfg", source="x", file="benchmark/configs/new-cfg.json",
                             reduced=[], why="x"))
    b["workloads"].append(dict(name="new-cfg.u8.new", config="new-cfg", traffic="u8.new",
                               chips=1, why="x"))
    b["per_layer"].append(dict(name="new.metric", unit="%", better="higher",
                               source="host_clock", layer="ingest", moves="mps",
                               workloads=["new-cfg.u8.new"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell(str(tmp_path), "new-cfg.u8.new", str(bench))
    assert cell.config["name"] == "new-cfg" and cell.traffic["entry"] == "single"
    assert cell.limits == dict(values_off=0)
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert {m["name"] for m in cell.end_to_end} == {"mps", "bpp", "setup_s"}
    mod = spec.load_module("metrics", "new.metric", str(bench))
    assert mod.read(None) == 42.0 and "ingest" in mod.SPANS
    pool = inputs.make_pool(H.ROOT, cell.config, cell.traffic, 3, cell.bench_dir)
    assert [r[0].shape for r in pool.requests] == [(3, 48, 64)] * 2
    loop = drivers.load(cell.traffic, cell.bench_dir)
    window = loop.run(H.cpu_encoder(), pool, cell.traffic, 1.0, 1.0, pool.order())
    assert [r.idx for r in window.requests] == [0, 1, 0]
    assert all(r.ok and r.outputs[0][:2] == b"\xff\x0a" for r in window.requests)


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for w in b["workloads"]:
        cell = spec.load_cell(H.ROOT, w["name"])
        assert set(cell.limits) == {"values_off", "blocks_off_ppm"}
        assert callable(spec.load_module("generators", cell.config["generator"]).Pool)
        assert callable(drivers.load(cell.traffic).run)
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
    assert set(spec.roofline_modules()) >= {"aq_kernel", "strategy_kernel", "quantize_kernel",
                                             "tokenize_kernel", "compact_rows_kernel",
                                             "copy_sections_kernel"}


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=H.ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, H.ROOT])))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    code = textwrap.dedent('''
        import json, os, sys
        from jxlbench import main, check, drivers, readers, spec
        from jxlbench.reference import golden, parse
        from jxl_tiny_tpu_torch import encoder
        from jxl_tiny_tpu_torch.ops import programs
        for kind in ("metrics", "roofline", "generators", "loops"):
            for f in os.listdir(os.path.join(spec.BENCH_DIR, kind)):
                if f.endswith(".py"):
                    spec.load_module(kind, f[:-3])
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    ''')
    top = _modules_after(code)
    assert "jxl_tiny_tpu_torch" in top
    assert not top & set(main.FORBIDDEN)
    # Whole top-level names: the port's name begins with the JAX package's.
    sys.modules.setdefault("jxl_tiny_tpu_torch_like", sys)
    try:
        assert "jxl_tiny_tpu" not in main.forbidden_modules()
    finally:
        del sys.modules["jxl_tiny_tpu_torch_like"]


def test_the_reference_imports_nothing_of_the_port():
    code = textwrap.dedent('''
        import json, sys
        from jxlbench import check, inputs, spec
        from jxlbench.reference import golden, parse, group_np, pipeline_np
        spec.load_module("generators", "photo_variants")
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    ''')
    top = _modules_after(code)
    assert not top & {"jxl_tiny_tpu_torch", "jxl_tiny_tpu", "jax", "torch"}
    ref_dir = os.path.join(BENCH, "jxlbench", "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            with open(os.path.join(ref_dir, f)) as fh:
                assert "jxl_tiny_tpu" not in "".join(
                    line for line in fh if line.lstrip().startswith(("import", "from")))


def test_small_cell_on_the_cpu_is_correct():
    r = H.run(H.small_cell("u8.single"), seed=2**31 + 3)
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == {"mps", "bpp", "setup_s", "latency_p95_ms"}
    assert 0.2 < r["metrics"]["bpp"]["value"] < 0.6
    assert list(r)[-1] == "check"


def test_small_stream_and_batch_on_the_cpu_are_correct():
    r = H.run(H.small_cell("u8.stream"), seed=11)
    assert r["correct"], r["check"]
    r = H.run(H.small_cell("u8.batch64", tile=512, batch=4, answers=2), seed=12)
    assert r["correct"], r["check"]
    assert r["attempted"] % 4 == 0


def test_traced_small_cell_reads_the_host_spans():
    names = ("ingest.host_ms_per_mp", "programs.queue_ms_per_mp", "entropy.host_ms_per_mp",
             "assembly.host_ms_per_mp", "program_b.dispatches_per_image",
             "programs.replay_share", "device.idle_share")
    r = H.run(H.small_cell("u8.single", per_layer=names), seed=13, trace=1)
    assert r["correct"], r["check"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for k in names[:4]:
        assert m[k] > 0, k
    assert m["program_b.dispatches_per_image"] >= 1.0
    assert m["programs.replay_share"] == 0.0  # on the CPU every program runs eagerly
    assert m["device.idle_share"] == 100.0
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
