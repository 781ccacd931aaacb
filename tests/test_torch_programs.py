"""The port's compiled programs (jxl_tiny_tpu_torch/ops/programs.py), the
counterpart of jax.jit: the keys, the first call / capture / replay rule,
the clones a replay returns, eviction, the launch accounting, threads and
the explicit eager rules.

On the CPU a fake capturer stands in for CUDA graphs: a "graph" is the
program with its input buffers and outputs, and a replay runs it again
into the captured outputs with its kernel launches recorded aside, as the
card runs none of the wrappers' bodies. The `gpu` cases capture real
graphs and hold every replay to the eager bytes (run them on the card with
--noconftest: they import nothing of JAX)."""
import copy
import os
import threading

import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import _build
from jxl_tiny_tpu_torch.ops import programs as PR
from jxl_tiny_tpu_torch.tools import kernel_check as KC
from jxl_tiny_tpu_torch.utils import debug_mode

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")
STATIC = EncoderConfig(optimize_code=False)
SMALL = ("photo256", "gradient512", "odd131x77", "tiny64")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    return (rng.random((3, h, w)) ** 2.2).astype(np.float32)


class FakeGraphs:
    """programs.CudaGraphs on the CPU: a graph is [fn, inputs, outputs];
    each capture reserves `pool` bytes."""

    def __init__(self, pool=0):
        self.pool, self.destroyed = pool, 0

    def capture(self, fn, inputs):
        out = fn(*inputs)
        return [fn, inputs, out], out, self.pool

    def replay(self, graph):
        fn, inputs, out = graph
        with _build.recording():  # a replay runs none of the wrappers' bodies
            new = fn(*inputs)
        for k, v in out.items():
            if isinstance(v, torch.Tensor):
                v.copy_(new[k])

    def destroy(self, graph):
        graph.clear()
        self.destroyed += 1

    def synchronize(self, device):
        pass

    def pool_limit(self, device):
        return 1 << 40


@pytest.fixture
def fake(monkeypatch):
    """The encoder's programs on the CPU through a fresh cache with the fake
    capturer (the CPU counted as a card)."""
    cache = PR.ProgramCache(FakeGraphs())
    monkeypatch.setattr(PR, "_cache", cache)
    monkeypatch.setattr(PR, "_on_card", lambda device: True)
    return cache


@pytest.fixture
def fake_lib(monkeypatch):
    """_build.load answering every launcher with success, so that
    _build.launch counts on the CPU."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "load", lambda name, bind, flags=None: Lib())


class Wrapper:
    launches = 0


def _launch(w):
    _build.launch(w, "fake", None, "entry", "fake", (), [])


def _keys(cache, name):
    return [k for k in cache.by_key if k.name == name]


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def test_program_key_fields():
    t = torch.zeros((1, 3, 64, 64), dtype=torch.float16)
    base = PR.program_key("analyze_batch_packed", [t], dict(cap=32768, kernels=True), "cpu")
    assert base == PR.program_key("analyze_batch_packed", [((1, 3, 64, 64), torch.float16)],
                                  dict(kernels=True, cap=32768), "cpu")
    others = [
        PR.program_key("pack_batch_sections", [t], dict(cap=32768, kernels=True), "cpu"),
        PR.program_key("analyze_batch_packed", [t.float()], dict(cap=32768, kernels=True), "cpu"),
        PR.program_key("analyze_batch_packed", [t[:, :, :32]], dict(cap=32768, kernels=True),
                       "cpu"),
        PR.program_key("analyze_batch_packed", [t], dict(cap=65536, kernels=True), "cpu"),
        PR.program_key("analyze_batch_packed", [t], dict(cap=32768, kernels=False), "cpu"),
        PR.program_key("analyze_batch_packed", [t], dict(cap=32768, kernels=True), "meta"),
    ]
    assert len({base, *others}) == 7
    assert "analyze_batch_packed(float16[1, 3, 64, 64]; cap=32768, kernels=True; cpu)" == str(base)


@pytest.mark.parametrize("change", ["none", "distance", "cap", "cfl", "blocks", "kernels",
                                    "tables", "n", "h", "w", "u8", "static"])
def test_job_key_changes_with_its_arguments_only(fake, change, monkeypatch):
    """The key of a job's pixel program (program A, or the one-pass
    program) changes with each static argument, N, H, W, the upload type
    (u8 against float; a float16 upload needs 2 MP, F16_AUTO_F32_PIXELS),
    kernels, the tables' identity and the tier, and with nothing else (not
    the pixels' values). The programs themselves are not run here."""
    keys = []

    def record(name, fn, inputs, static, device):
        keys.append(PR.program_key(name, inputs, static, device))
        return {"small": torch.zeros(1)}

    monkeypatch.setattr(PR, "run", record)
    monkeypatch.setattr(TE.DeviceEncodeJob, "_start_a", lambda self: self._run_a(self.cap))
    base = dict(imgs=[_img(0)], distance=1.0, cap=32768, config=EncoderConfig(),
                kernels=True, upload_dtype=np.float32)
    kw = dict(base)
    if change == "none":
        kw["imgs"] = [_img(1)]
    elif change == "distance":
        kw["distance"] = 2.0
    elif change == "cap":
        kw["cap"] = 65536
    elif change in ("cfl", "blocks"):
        kw["config"] = EncoderConfig(**{("optimize_chroma_from_luma" if change == "cfl"
                                         else "optimize_block_sizes"): False})
    elif change == "kernels":
        kw["kernels"] = False
    elif change == "tables":
        kw["tables"] = copy.copy(TE.device_tables("cpu"))
    elif change == "n":
        kw["imgs"] = [_img(0), _img(1)]
    elif change in ("h", "w"):
        kw["imgs"] = [_img(0, *((72, 64) if change == "h" else (64, 72)))]
    elif change == "u8":
        kw["imgs"] = [linear_to_srgb_u8(_img(0))]
    elif change == "static":
        kw["config"] = STATIC

    for args in (dict(base), kw):
        TE.DeviceEncodeJob(args.pop("imgs"), device="cpu", **args)
    k0, k1 = keys
    if change == "none":
        assert k0 == k1
        return
    assert k0 != k1
    if change == "static":
        assert (k0.name, k1.name) == ("analyze_batch_packed", "analyze_pack_batch_static")
        return
    diff = {f for f in ("inputs", "static") if getattr(k0, f) != getattr(k1, f)}
    assert diff == ({"inputs"} if change in ("n", "h", "w", "u8") else {"static"})
    if diff == {"static"}:
        changed = {a for (a, v), (_, u) in zip(k0.static, k1.static) if v != u}
        want = {"distance": {"distance", "inv_scale", "scale", "scale_dc", "x_qm_mul"}}
        assert changed == want.get(change, {change})


# ---------------------------------------------------------------------------
# First call, capture, replay; clones; eviction
# ---------------------------------------------------------------------------


def test_first_call_runs_eagerly_the_second_captures(fake_lib):
    """A key's first call is an eager run (nothing captured: a key seen once
    costs what eager costs); its second captures and replays; later calls
    replay. Every replay returns clones: a later replay leaves an earlier
    call's outputs as they were."""
    cache = PR.ProgramCache(FakeGraphs())
    w = Wrapper()

    def program(x):
        _launch(w)
        return {"y": x * 2, "n": 3}

    key = PR.program_key("p", [((3,), torch.float32)], {}, "cpu")
    outs = [cache.run(key, program, [torch.full((3,), float(k))]) for k in range(4)]
    assert [o["y"].tolist() for o in outs] == [[2.0 * k] * 3 for k in range(4)]
    assert all(o["n"] == 3 for o in outs)
    assert len({id(o["y"]) for o in outs} | {id(cache.programs[key].outputs["y"])}) == 5
    st = cache.stats()
    assert (st["eager"], st["captures"], st["replays"], st["programs"]) == (1, 1, 3, 1)
    assert w.launches == 4  # the eager call and three replays: once a call


def test_stream_in_flight_gets_distinct_outputs_and_one_graph(fake):
    """encode_images_device at depth 3 over four distinct same-shape images:
    the bytes are the eager serial encodes' though three jobs are in flight
    on one graph a program; a later encode replays (no new capture)."""
    imgs = [_img(s) for s in range(4)]
    with PR.eager():
        want = [TE.encode_image_device(im, device="cpu") for im in imgs]
    assert fake.stats()["captures"] == 0  # eager() bypasses the cache
    got = list(TE.encode_images_device(imgs, device="cpu", depth=3))
    assert got == want
    for name in ("analyze_batch_packed", "pack_batch_sections"):
        assert len(_keys(fake, name)) == 1
    st = fake.stats()
    assert (st["eager"], st["captures"], st["programs"], st["replays"]) == (2, 2, 2, 6)
    assert TE.encode_image_device(imgs[2], device="cpu") == want[2]
    st = fake.stats()
    assert (st["captures"], st["replays"]) == (2, 8)


def test_capacity_retries_pick_other_keys(fake):
    """An image that overflows the first token cap and the first section
    budget: each retry runs the next key; the bytes are the eager encode's
    on the first call, the capture and the replay alike."""
    img = read_pfm(os.path.join(TESTDATA, "photo256.pfm"))
    with PR.eager():
        want = TE.encode_image_device(img, device="cpu")
    for _ in range(3):  # first calls, captures, replays
        assert TE.encode_image_device(img, device="cpu", cap=128, ow=128) == want
    caps = {dict(k.static)["cap"] for k in _keys(fake, "analyze_batch_packed")}
    ows = {dict(k.static)["ow_ac"] for k in _keys(fake, "pack_batch_sections")}
    assert caps == {128, 32768} and 128 in ows and len(ows) > 1
    assert fake.stats()["captures"] == len(fake.by_key) and fake.stats()["replays"] > 0


def test_eviction_drops_the_least_recently_used():
    """Past the pool bound the least recently replayed programs go (never
    the one just captured); a dropped key's next call captures it again."""
    graphs = FakeGraphs(pool=10)
    cache = PR.ProgramCache(graphs, max_pool_bytes=25)
    keys = [PR.program_key(f"p{i}", [((2,), torch.float32)], {}, "cpu") for i in range(3)]

    def program(x):
        return {"y": x + 1}

    for k in (keys[0], keys[1], keys[0], keys[1], keys[0]):  # p0 used last
        cache.run(k, program, [torch.ones(2)])
    assert set(cache.programs) == {keys[0], keys[1]} and cache.evictions == 0
    for _ in range(2):
        cache.run(keys[2], program, [torch.ones(2)])
    assert set(cache.programs) == {keys[0], keys[2]}
    assert cache.evictions == graphs.destroyed == 1 and cache.pool_bytes() == 20
    out = cache.run(keys[1], program, [torch.full((2,), 4.0)])  # captured again
    assert torch.equal(out["y"], torch.full((2,), 5.0))
    assert cache.by_key[keys[1]]["captures"] == 2 and set(cache.programs) == {keys[1], keys[2]}

    solo = PR.ProgramCache(FakeGraphs(pool=40), max_pool_bytes=25)
    for _ in range(3):  # over the bound alone: kept, replayed
        solo.run(keys[0], program, [torch.ones(2)])
    assert solo.stats()["programs"] == 1 and solo.stats()["replays"] == 2


def test_job_that_raises_leaves_the_cache_usable(fake, monkeypatch):
    """A job whose result() raises, and a stream image that fails once in
    pack() and is retried, leave the cache as it was: the next encodes
    replay and give the eager bytes."""
    img = _img(7)
    TE.encode_image_device(img, device="cpu")
    job = TE.DeviceEncodeJob([img], device="cpu")  # captures

    def broken(*args, **kwargs):
        raise OSError("read failed")

    with monkeypatch.context() as m:
        m.setattr(TE._SectionPlan, "read", broken)
        with pytest.raises(OSError):
            job.result()

    real_pack, failed = TE.DeviceEncodeJob.pack, []

    def pack_once_broken(self):
        if not failed:
            failed.append(self)
            raise OSError("pack failed")
        return real_pack(self)

    monkeypatch.setattr(TE.DeviceEncodeJob, "pack", pack_once_broken)
    retries = TE.RETRY_COUNT
    imgs = [_img(8), _img(9), img]
    got = list(TE.encode_images_device(imgs, device="cpu"))
    assert TE.RETRY_COUNT == retries + 1
    monkeypatch.setattr(TE.DeviceEncodeJob, "pack", real_pack)
    with PR.eager():
        assert got == [TE.encode_image_device(im, device="cpu") for im in imgs]
    st = fake.stats()
    assert (st["captures"], st["programs"]) == (2, 2) and st["replays"] >= 6


# ---------------------------------------------------------------------------
# Launch accounting, threads, capture failures, the eager rules
# ---------------------------------------------------------------------------


def test_replays_add_the_captured_launches(fake_lib):
    """_build.launch counts on the wrapper, or, while this thread captures,
    in the capture's record; each replay adds the record again."""
    w = Wrapper()
    cache = PR.ProgramCache(FakeGraphs())

    def program(x):
        _launch(w)
        _launch(w)
        return {"y": x * 2}

    key = PR.program_key("p", [((3,), torch.float32)], {}, "cpu")
    assert torch.equal(cache.run(key, program, [torch.ones(3)])["y"], torch.full((3,), 2.0))
    assert w.launches == 2  # the first call ran eagerly
    cache.run(key, program, [torch.ones(3)])  # captured (counts nothing), replayed
    assert w.launches == 4 and cache.programs[key].launches == {w: 2}
    for _ in range(3):
        cache.run(key, program, [torch.ones(3)])
    assert w.launches == 10
    assert cache.stats()["replays"] == 4 and cache.stats()["captures"] == 1


def test_a_capture_leaves_other_threads_launches_counted(fake_lib):
    """A launch from another thread while one thread captures counts on the
    wrapper (the capture's record is the capturing thread's alone), and a
    second thread's call waits for the capture, then replays."""
    w, other = Wrapper(), Wrapper()
    started, go = threading.Event(), threading.Event()

    def program(x):
        _launch(w)
        if PR.capturing() and not go.is_set():
            started.set()
            assert go.wait(10)
        return {"y": x + 1}

    cache = PR.ProgramCache(FakeGraphs())
    key = PR.program_key("p", [((2,), torch.float32)], {}, "cpu")
    cache.run(key, program, [torch.ones(2)])  # eager
    outs = {}
    capture = threading.Thread(target=lambda: outs.update(
        a=cache.run(key, program, [torch.full((2,), 2.0)])))
    replay = threading.Thread(target=lambda: outs.update(
        b=cache.run(key, program, [torch.full((2,), 5.0)])))
    capture.start()
    assert started.wait(10)
    assert not PR.capturing()  # this thread is not capturing
    replay.start()
    _launch(other)
    _launch(w)
    go.set()
    capture.join(10)
    replay.join(10)
    assert other.launches == 1
    assert w.launches == 1 + 1 + 2  # eager, this thread's, two replays
    assert outs["a"]["y"].tolist() == [3.0, 3.0] and outs["b"]["y"].tolist() == [6.0, 6.0]
    assert cache.stats()["captures"] == 1 and cache.stats()["replays"] == 2


def test_count_programs_counts_replays(fake):
    """kernel_check.count_programs: eager calls and replays, not captures."""
    img = _img(3)
    TE.encode_image_device(img, device="cpu")  # eager first calls
    runs, restore = KC.count_programs(TE, ("analyze_batch_packed", "pack_batch_sections"))
    try:
        TE.encode_image_device(img, device="cpu")  # captures + replays
        TE.encode_image_device(img, device="cpu")  # replays
        TE.encode_image_device(_img(4, 72, 64), device="cpu")  # eager first calls
    finally:
        restore()
    assert runs == {"analyze_batch_packed": 3, "pack_batch_sections": 3}


def test_capture_failure_raises_and_names_the_key_and_op(fake, monkeypatch):
    from jxl_tiny_tpu_torch.ops import pipeline as PL

    real = PL.to_xyb

    def to_xyb(groups):
        if PR.capturing():
            raise RuntimeError("operation not permitted when stream is capturing")
        return real(groups)

    monkeypatch.setattr(PL, "to_xyb", to_xyb)
    img = _img(6)
    TE.encode_image_device(img, device="cpu")  # the first call runs eagerly
    with pytest.raises(PR.CaptureError) as e:
        TE.encode_image_device(img, device="cpu")
    msg = str(e.value)
    assert "analyze_batch_packed(float32[1, 3, 64, 64]" in msg and "cap=32768" in msg
    assert "ops/pipeline.py" in msg and "to_xyb" in msg and "not permitted" in msg
    st = fake.stats()
    assert (st["captures"], st["programs"], st["replays"]) == (0, 0, 0)


@pytest.mark.parametrize("mode", ["eager", "debug_mode"])
def test_eager_rules_bypass_the_cache(fake, mode):
    """Inside eager() and debug_mode() the programs run op by op; debug
    mode also drops every captured program on entry and on exit."""
    img = _img(2)
    for _ in range(2):
        want = TE.encode_image_device(img, device="cpu")
    st = fake.stats()
    assert st["programs"] == 2 and st["captures"] == 2
    ctx = PR.eager() if mode == "eager" else debug_mode()
    with ctx:
        assert not PR.graphs_enabled("cpu")
        assert len(fake.programs) == (2 if mode == "eager" else 0)
        assert TE.encode_image_device(img, device="cpu") == want
        assert TE.encode_image_device(img, device="cpu", config=STATIC)
        assert fake.stats()["captures"] == 2 and fake.stats()["replays"] == 2
    assert len(fake.programs) == (2 if mode == "eager" else 0)
    assert PR.graphs_enabled("cpu")


def test_cpu_never_reaches_the_cache(monkeypatch):
    """The real rule: device='cpu' runs eagerly on every entry point."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the program cache")

    monkeypatch.setattr(PR.ProgramCache, "run", refuse)
    assert not PR.graphs_enabled("cpu") and not PR.graphs_enabled(torch.device("cpu"))
    img = _img(1)
    assert TE.encode_image_device(img, device="cpu", config=STATIC)
    assert list(TE.encode_images_device([img, img], device="cpu"))
    assert TE.encode_batch_device([img, img], device="cpu")


def test_mesh_and_host_packed_path_run_eagerly(fake, monkeypatch):
    """The encoder's own rules: a mesh (here one gloo rank on the CPU, the
    CPU counted as a card) and the host-packed path never reach the cache."""
    import socket

    import torch.distributed as dist

    from jxl_tiny_tpu_torch.parallel import sharding as SH

    def refuse(*args, **kwargs):
        raise AssertionError("the program cache was reached")

    img = _img(11)
    with monkeypatch.context() as m:
        m.setattr(PR.ProgramCache, "run", refuse)
        assert PR.graphs_enabled("cpu")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                                rank=0)
        try:
            mesh = SH.make_mesh("cpu")
            got = TE.encode_image_device_mesh(img, mesh=mesh, upload_dtype=None)
        finally:
            dist.destroy_process_group()
        assert TE.encode_image_host_packed(img, device="cpu")
    with PR.eager():
        assert got == TE.encode_image_device(img, device="cpu")
    assert fake.stats()["captures"] == 0


# ---------------------------------------------------------------------------
# On the card: replays against eager encodes
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launches():
    wrappers, _ = KC.on_path_kernels()
    return {k: w.launches for k, w in wrappers.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["default", "static"])
@pytest.mark.parametrize("upload", ["float", "u8"])
@pytest.mark.parametrize("name", SMALL)
def test_replay_bytes_equal_eager_on_card(name, upload, tier):
    """The first encode of a shape runs eagerly, the second captures its
    programs and the third replays them: bytes and each wrapper's launches
    equal the eager encode's every time."""
    _card()
    PR.clear_programs()
    img = read_pfm(os.path.join(TESTDATA, f"{name}.pfm"))
    if upload == "u8":
        img = linear_to_srgb_u8(img)
    config = STATIC if tier == "static" else EncoderConfig()
    wrappers, _ = KC.on_path_kernels()
    runs = []
    for mode in ("eager", "first call", "capture", "replay"):
        for w in wrappers.values():
            w.launches = 0
        before = PR.stats()
        if mode == "eager":
            with PR.eager():
                data = TE.encode_image_device(img, config=config)
        else:
            data = TE.encode_image_device(img, config=config)
        after = PR.stats()
        runs.append((data, _launches(), {k: after[k] - before[k]
                                         for k in ("eager", "captures", "replays")}))
    (eager, l_eager, _), *graphs = runs
    assert all(data == eager and launches == l_eager for data, launches, _ in graphs)
    assert all(l_eager.values())
    assert graphs[0][2]["captures"] == 0 and graphs[1][2]["captures"] >= 1
    assert graphs[2][2]["captures"] == 0 and graphs[2][2]["replays"] >= 1


@pytest.mark.gpu
def test_stream_and_overflow_on_card():
    """A depth-3 stream of four distinct same-shape images equals their
    serial eager encodes, as first calls, captures and replays; an image
    that overflows the first cap and section budget gives the eager
    bytes."""
    _card()
    PR.clear_programs()
    photo = read_pfm(os.path.join(TESTDATA, "photo256.pfm"))
    imgs = [photo, np.ascontiguousarray(photo[:, :, ::-1]),
            np.ascontiguousarray(photo[:, ::-1, :]), np.ascontiguousarray(photo[:, ::-1, ::-1])]
    with PR.eager():
        want = [TE.encode_image_device(im) for im in imgs]
        grad = read_pfm(os.path.join(TESTDATA, "gradient512.pfm"))
        want_grad = TE.encode_image_device(grad)
    for _ in range(3):
        assert list(TE.encode_images_device(imgs, depth=3)) == want
        assert TE.encode_image_device(grad, cap=1024, ow=128) == want_grad
    assert PR.stats()["replays"] > 0
    PR.clear_programs()
    assert PR.stats()["programs"] == 0
