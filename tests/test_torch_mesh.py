"""The port's multi-GPU scale-out (jxl_tiny_tpu_torch/parallel/) on the CPU:
ranks are processes over gloo, started by the package's launcher
(jxl_tiny_tpu_torch/tools/multihost_dryrun.launch), each on one torch
thread, with a 60 s group timeout and a launch deadline.

(a) the owner exchange's static routing (_dc_owner_tables) equals the JAX
    package's for 220x2300 at 2, 4 and 8 ranks and 2160x3840 at 2 and 4
(c) encode_image_device_mesh at 2 and 4 ranks equals the port's
    encode_image_device on the 300x700 image of the JAX package's
    tests/test_sharding.py (6 groups: padding groups on 4 ranks; one DC
    group: padding DC rows): default tier on float and on u8 sRGB, static
    tier, fixed 8x8 blocks without CfL; and the owner exchange on a
    220x2300 image whose DC groups' maps cross ranks
(d) a token cap and a section budget `ow` small enough that some ranks
    overflow and others do not: the retries end with the same bytes
(e) encode_batch_device(mesh=) on three 96x128 images at 2 and 4 ranks
    (padding images) equals the single-card batch, both tiers
(f) a rank that raises (bad input on rank 1) fails the launch quickly
(g) the group-level entry points (analyze_groups_packed_sharded,
    pack_ac_sections_sharded) at 4 ranks equal the one-device programs on
    8 groups, as the JAX package's test_packed_path_shard_invariance
(h) parallel.multihost's encode_image_multihost at 2 and 4 ranks equals
    the single encode with float32 upload, and host0_gather stacks every
    rank's tensors on rank 0; initialize(device=None) raises on a host
    without a card before any process group comes up
(i) the host-packed path over 2 ranks (analyze_groups_sharded,
    encode_image_host_packed(mesh=)): every rank's bytes equal the one-rank
    encode, fast, full and with the cap retry, and the histogram summed
    over the ranks equals one device's
(j) Mesh.stats() on every rank at 2 and 4 ranks equals the benchmark's
    count of the collectives from the geometry alone
    (benchmark/roofline/mesh_collectives.py) on the 220x2300 image (two
    DC groups), and the mesh's spans open once a program and once a
    collective call
gpu: two ranks sharing the card over gloo, on a 1024x1024 crop of
    photo8mp: bytes equal to encode_image_device, and every kernel call of
    rank 0 equal to its plain version

This file imports no JAX at module level (the gpu case runs on a machine
without it, under --noconftest); tests/test_torch_mesh_jax.py holds the
comparisons with the JAX package's mesh programs. Every comparison is of
integers or bytes: exact."""
import os
import time

import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig, compute_distance_params
from jxl_tiny_tpu_torch.entropy.entropy_write import build_ac_device_code
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
from jxl_tiny_tpu_torch.ops import pack_kernels as PK
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.parallel import sharding as SH
from jxl_tiny_tpu_torch.tables import device_tables
from jxl_tiny_tpu_torch.tools import multihost_dryrun as MD

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
IMG = MD.synthetic_image()  # 300x700
WIDE = MD.synthetic_image(220, 2300, seed=21)  # 9 groups, 2 DC groups
CONFIGS = {
    "default": None,
    "static": EncoderConfig(optimize_code=False),
    "fixed8x8": EncoderConfig(optimize_block_sizes=False, optimize_chroma_from_luma=False),
}


def _batch_images():
    """The three 96x128 images of the JAX package's batch mesh test."""
    rng = np.random.RandomState(17)
    return [
        np.clip(0.5 + 0.3 * np.sin(np.mgrid[0:96, 0:128][1] * (0.03 + 0.01 * k))[None]
                + rng.randn(3, 96, 128) * 0.03, 0, 1).astype(np.float32)
        for k in range(3)
    ]


def _groups(n=8):
    """The eight groups of the JAX package's test_packed_path_shard_invariance."""
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    base = np.stack([0.5 + 0.4 * np.sin(xx * 0.06) * np.cos(yy * 0.04),
                     0.5 + 0.3 * np.sin((xx + yy) * 0.025),
                     0.4 + 0.2 * np.cos(xx * 0.015)])
    return np.stack([np.clip(base * (0.6 + 0.05 * k) + rng.randn(3, 256, 256) * 0.02, 0, 1)
                     for k in range(n)]).astype(np.float32)


BATCH = _batch_images()
GROUPS = _groups()
F32 = dict(upload_dtype=None)
# (name, image, encode_image_device_mesh kwargs); the reference is the
# port's single encode with the same image and configuration.
IMAGE_CASES = [
    ("default_float", IMG, dict(F32)),
    ("default_u8", linear_to_srgb_u8(IMG), {}),
    ("static", IMG, dict(F32, config=CONFIGS["static"])),
    ("fixed8x8", IMG, dict(F32, config=CONFIGS["fixed8x8"])),
    ("owner_wide", WIDE, dict(F32, dc_exchange="owner")),
    ("gather_wide", WIDE, dict(F32)),
    # Groups 0-2 hold 8,947-12,119 tokens and groups 3-5 about 2,000; AC
    # sections of groups 0-2 need 444-604 words, of groups 3-5 ~110.
    ("cap_retry", IMG, dict(F32, cap=4096)),
    ("ow_retry", IMG, dict(F32, ow=256)),
]
# encode_image_host_packed(mesh=) at 2 ranks (i): fast, full, and a cap that
# groups 0-2 overflow (rank 0's) and groups 3-5 do not (rank 1's).
HOST_CASES = [("fast", {}), ("full", dict(fast=False)), ("cap_retry", dict(cap=4096))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's CPU encodes (several test
    processes share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One launch a rank count, running every case of (c), (d), (e), (g)
    and (h): {n_ranks: output directory}."""
    runs = {}

    def get(n):
        if n not in runs:
            out = tmp_path_factory.mktemp(f"mesh{n}")
            cases = [dict(name=name, image=img, kwargs=kw) for name, img, kw in IMAGE_CASES]
            cases += [dict(name=f"batch_{tier}", images=BATCH,
                           kwargs=dict(F32, config=CONFIGS[tier]))
                      for tier in ("default", "static")]
            yb = np.full(8, 32, np.int32)
            tasks = [(MD.encode_cases, (cases, str(out))),
                     (MD.multihost_entry, (IMG, str(out))),
                     (MD.collective_counts, (WIDE, str(out)))]
            if n == 2:
                tasks.append((MD.host_packed_cases, (IMG, HOST_CASES, str(out))))
            if n == 4:
                os.makedirs(out / "groups")
                tasks.append((MD.group_programs, (GROUPS, yb, yb, str(out / "groups"))))
            MD.launch(n, MD.run_tasks, (tasks,), timeout_s=300)
            runs[n] = out
        return runs[n]

    return get


@pytest.mark.parametrize("ysize,xsize,n", [(220, 2300, 2), (220, 2300, 4), (220, 2300, 8),
                                           (2160, 3840, 2), (2160, 3840, 4)])
def test_dc_owner_tables_match_jax(ysize, xsize, n):
    from jxl_tiny_tpu.parallel import sharding as JSH

    g = -(-ysize // 256) * -(-xsize // 256)
    gpad = SH._pad_to(g, n)
    _, gps, _, _, gd_ps = SH._mesh_geometry(ysize, xsize, gpad, n)
    assert JSH._mesh_geometry(ysize, xsize, gpad, n) == SH._mesh_geometry(ysize, xsize, gpad, n)
    deltas, sel = SH._dc_owner_tables(ysize, xsize, n, gps, gd_ps)
    j_deltas, j_sel = JSH._dc_owner_tables(ysize, xsize, n, gps, gd_ps)
    assert deltas == j_deltas
    assert sel.dtype == j_sel.dtype and np.array_equal(sel, j_sel)


def test_owner_routes_deliver_every_member_once():
    """The all_to_all routing the port derives from the tables: what rank q
    sends rank r is what r expects from q, and every member slot of an
    image group is filled exactly once."""
    ysize, xsize, n = 2160, 3840, 4
    gpad = SH._pad_to(135, n)
    _, gps, _, _, gd_ps = SH._mesh_geometry(ysize, xsize, gpad, n)
    routes = [SH._owner_routes(ysize, xsize, n, gps, gd_ps, r, torch.device("cpu"))
              for r in range(n)]
    for r in range(n):  # rank r owns DC group r of the 2x2 grid of 9x15 groups
        assert [routes[q][1][r] for q in range(n)] == routes[r][3]
        slots = routes[r][2].numpy()
        dy, dx = divmod(r, 2)
        members = min(8, 9 - 8 * dy) * min(8, 15 - 8 * dx)
        assert len(set(slots.tolist())) == len(slots) == members
    assert sum(len(r[0]) for r in routes) == 135


@pytest.fixture(scope="module")
def singles():
    """The port's single-device encodes of IMAGE_CASES' images."""
    out = {}
    for name, img, kw in IMAGE_CASES:
        kw = {k: v for k, v in kw.items() if k not in ("dc_exchange", "cap", "ow")}
        key = (id(img), str(kw.get("config")), kw.get("upload_dtype", "f16"))
        if key not in out:
            out[key] = TE.encode_image_device(img, 1.0, device="cpu", **kw)
        out[name] = out[key]
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", [c[0] for c in IMAGE_CASES])
def test_mesh_encode_matches_single(mesh_runs, singles, case, n):
    with open(mesh_runs(n) / f"{case}.bin", "rb") as f:
        assert f.read() == singles[case]


@pytest.mark.parametrize("n", [2, 4])
def test_multihost_entry_points(mesh_runs, singles, n):
    """encode_image_multihost (float32 upload) equals the single encode of
    the float image; host0_gather stacks every rank's tensors on rank 0."""
    assert (mesh_runs(n) / "multihost.bin").read_bytes() == singles["default_float"]
    got = np.load(mesh_runs(n) / "host0_gather.npz")
    ranks = np.arange(n, dtype=np.int32)
    assert np.array_equal(got["arr_0"], np.arange(5, dtype=np.int32) + 10 * ranks[:, None])
    assert np.array_equal(got["arr_1"], np.broadcast_to(ranks[:, None, None], (n, 2, 3)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tier", ["default", "static"])
def test_mesh_batch_matches_single_card_batch(mesh_runs, tier, n):
    ref = TE.encode_batch_device(BATCH, 1.0, upload_dtype=None, config=CONFIGS[tier],
                                 device="cpu")
    got = []
    for k in range(len(BATCH)):
        with open(mesh_runs(n) / f"batch_{tier}.{k}.bin", "rb") as f:
            got.append(f.read())
    assert got == ref


def test_group_level_entry_points_match_one_device(mesh_runs):
    """4 ranks (2 groups each) against the one-device programs on all 8."""
    distp = compute_distance_params(1.0)
    tables = device_tables("cpu")
    yb = torch.full((8,), 32, dtype=torch.int32)
    one = PL.analyze_groups_packed(torch.from_numpy(GROUPS), yb, yb, distp, 32768, tables)
    _, d = build_ac_device_code(one["hist"][0].numpy(), PK.ac_base64_map())
    sec = PK.pack_ac_sections(one["stream"][:, :32768].contiguous(), one["totals"],
                              torch.from_numpy(np.asarray(d, np.float32)), 8192,
                              PK.sections_wcap(8, 8192))
    ranks = [np.load(mesh_runs(4) / "groups" / f"rank{r}.npz") for r in range(4)]
    for r, got in enumerate(ranks):
        sl = slice(2 * r, 2 * r + 2)
        assert np.array_equal(got["totals"], one["totals"][sl].numpy())
        assert np.array_equal(got["stream"], one["stream"][sl].numpy())
        assert np.array_equal(got["hist"], one["hist"][0].numpy())
        assert np.array_equal(got["bits"], sec["bits"].numpy())
    bits = sec["bits"].numpy()
    words = sec["words"].numpy()
    offs = sec["word_offs"].numpy()
    for k in range(8):
        r, nw = k // 2, (int(bits[k]) + 31) // 32
        local = ranks[r]["word_offs"][k]
        assert np.array_equal(ranks[r]["words"][local: local + nw], words[offs[k]: offs[k] + nw])


def _roofline_counts():
    import importlib.util

    path = os.path.join(REPO, "benchmark", "roofline", "mesh_collectives.py")
    spec = importlib.util.spec_from_file_location("mesh_collectives", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.counts


@pytest.mark.parametrize("n", [2, 4])
def test_collective_bytes_match_the_mesh_counters(mesh_runs, n):
    """Every rank's counts of one encode of WIDE (9 groups, 2 DC groups)
    equal the benchmark's geometry-only count for that rank."""
    import json

    counts = _roofline_counts()
    for r in range(n):
        got = json.loads((mesh_runs(n) / f"counts.rank{r}.json").read_text())["stats"]
        assert got == counts(9, 2, n, r), r
        assert got["gather0"]["received" if r == 0 else "sent"] > 0


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_spans_open_once_a_call(mesh_runs, n):
    import json

    want = {"mesh:program_a": 1, "mesh:program_b": 1, "mesh.psum": 1, "mesh.all_gather": 3,
            "mesh.gather0": 1}
    for r in range(n):
        spans = json.loads((mesh_runs(n) / f"counts.rank{r}.json").read_text())["spans"]
        assert {k: v for k, v in spans.items() if k.startswith("mesh")} == want, r


def test_failing_rank_ends_the_launch(tmp_path):
    """Rank 1 gets a 2-D image and raises; rank 0 would wait in the first
    collective. The launch must fail with rank 1's error, well inside the
    group's 60 s timeout."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        MD.launch(2, MD.encode_cases,
                  ([dict(name="bad", image=IMG, kwargs=F32, fail_rank=1)], str(tmp_path)),
                  timeout_s=120)
    assert time.monotonic() - t < 60
    assert not (tmp_path / "bad.bin").exists()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        SH.make_mesh("cpu")


@pytest.mark.parametrize("case", [c[0] for c in HOST_CASES])
def test_host_packed_mesh_matches_one_rank(mesh_runs, case):
    kw = dict(HOST_CASES)[case]
    want = TE.encode_image_host_packed(IMG, 1.0, device="cpu", **kw)
    for r in range(2):
        assert (mesh_runs(2) / f"host_{case}.rank{r}.bin").read_bytes() == want, r


def test_sharded_histogram_matches_one_device(mesh_runs):
    from jxl_tiny_tpu_torch.ops import pipeline_full as PF

    groups, yb, xb = TE._extract_all_groups(IMG, TE.ImageDim(700, 300))
    one = PF.analyze_groups(torch.from_numpy(groups), torch.from_numpy(yb),
                            torch.from_numpy(xb), compute_distance_params(1.0),
                            device_tables("cpu"), with_hist=True)["hist"].numpy()
    got = np.load(mesh_runs(2) / "host_hist.npy")
    assert got.shape == (1980, 64) and np.array_equal(got, one)
    assert int(one.sum()) > 0


def test_initialize_without_a_card_raises():
    """device=None means this rank's card: no card, no process group."""
    import torch.distributed as dist

    from jxl_tiny_tpu_torch.parallel import multihost

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize(f"tcp://127.0.0.1:{MD.free_port()}", 1, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("url", ["tcp://10.0.0.1:2345", "udp://127.0.0.1:1"])
def test_initialize_refuses_other_hosts(url):
    from jxl_tiny_tpu_torch.parallel import multihost

    with pytest.raises(ValueError):
        multihost.initialize(url, 1, 0, device="cpu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_shared_card_mesh_on_card(cuda, tmp_path):
    """Two ranks on one card over gloo (NCCL refuses two ranks a card):
    bytes equal to encode_image_device of the same crop, and every kernel
    call of rank 0 (8 of the crop's 16 groups) equal to its plain version."""
    import json

    from jxl_tiny_tpu_torch.io.pfm import read_pfm

    path = os.path.join(REPO, "testdata", "photo8mp.pfm")
    crop = (512, 1536, 1024, 2048)
    MD.launch(2, MD.shared_card_rank, (("pfm", path, crop, False), str(tmp_path), ("default",),
                                       (0,)), device="cuda:0", backend="gloo", timeout_s=600)
    img = np.ascontiguousarray(read_pfm(path)[:, 512:1536, 1024:2048])
    ref = TE.encode_image_device(img, 1.0)
    for name in ("default", "recorded"):
        assert (tmp_path / f"{name}.bin").read_bytes() == ref
    rec = json.loads((tmp_path / "kernels_rank0.json").read_text())
    for name, held in rec["held"].items():
        assert held["calls"] >= 1 and rec["launches"][name] >= 1, name
        assert held["mismatches"] == 0, (name, held)
    assert rec["held"]["aq_field"]["shapes"][0][0] == 8
