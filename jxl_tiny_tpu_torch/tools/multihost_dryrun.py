"""Multi-process encode dry run, and the rank functions that the mesh tests
and chip_smoke.py start.

    python -m jxl_tiny_tpu_torch.tools.multihost_dryrun [--ranks 2]
        [--device cpu|cuda|cuda:0] [--backend gloo|nccl] [--exchange gather|owner]

spawns that many ranks (one process each, a process group over tcp on
127.0.0.1), encodes a 300x700 synthetic image (6 groups, one DC group:
padding groups, padding DC rows and the cross-rank DC layout) over the
global mesh, and checks that rank 0's bytes equal encode_image_device's in
this process. --device cuda gives each rank its own card (NCCL); cuda:0
puts every rank on one card (use --backend gloo).

`launch` is the launcher: rank functions live here, not in test files,
because spawned processes import them by name. Every group has a timeout
of at most 60 s and every launch a deadline; a rank that raises ends the
launch at once, with its traceback, and the other ranks are killed.
"""
import argparse
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np

from . import kernel_check as KC
from ..utils.profiling import device_time

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init_method, device, backend, group_timeout_s, fn, args):
    import torch
    import torch.distributed as dist

    from ..parallel import multihost

    if device == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    elif device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    multihost.initialize(init_method, world, rank, device, backend, group_timeout_s)
    try:
        fn(multihost.global_mesh(device), *args)
    finally:
        dist.destroy_process_group()


def launch(world, fn, args=(), device="cpu", backend=None, timeout_s=600.0,
           group_timeout_s=60.0):
    """Run fn(mesh, *args) in `world` spawned ranks and wait for all of
    them. device: "cpu", "cuda" (rank r on card r % count) or "cuda:<i>"
    (every rank on one card). Kernels and the native packer are built here
    first, so that the ranks only load them. Raises RuntimeError when a
    rank fails (its traceback in the message; the others are killed) or
    when timeout_s passes."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from ..cpp import build as native
    from ..ops import _build

    if device != "cpu":
        _build.build_all()
    native.native_packer()
    init = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(world, init, device, backend, group_timeout_s, fn, args),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{world} ranks did not finish within {timeout_s} s")
    except ProcessException as e:
        raise RuntimeError(f"rank {e.error_index} of {world} failed:\n{e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------


def synthetic_image(h=300, w=700, seed=12):
    """The smooth-plus-noise image of the JAX package's tests/test_sharding."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.4 * np.sin(xx * 0.04) * np.cos(yy * 0.05),
            0.5 + 0.3 * np.sin((xx + yy) * 0.02),
            0.4 + 0.2 * np.cos(xx * 0.012),
        ]
    ).astype(np.float32)
    return np.clip(img + rng.randn(3, h, w).astype(np.float32) * 0.02, 0, 1)


def load_image(spec):
    """An image array, or ("pfm", path, (y0, y1, x0, x1) or None, u8) read
    in the rank (large images are not pickled into every process)."""
    if isinstance(spec, np.ndarray):
        return spec
    from ..io.color import linear_to_srgb_u8
    from ..io.pfm import read_pfm

    _, path, crop, u8 = spec
    img = read_pfm(path)
    if crop is not None:
        y0, y1, x0, x1 = crop
        img = np.ascontiguousarray(img[:, y0:y1, x0:x1])
    return linear_to_srgb_u8(img) if u8 else img


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def run_tasks(mesh, tasks):
    """Several rank functions in one launch: tasks = [(fn, args), ...], each
    run as fn(mesh, *args) in turn (one process start for all of them)."""
    for fn, args in tasks:
        fn(mesh, *args)


def encode_cases(mesh, cases, out_dir):
    """Each case a dict(name, image (spec) or images (list of specs),
    kwargs, fail_rank): encode_image_device_mesh (image) or
    encode_batch_device(mesh=) (images). Rank 0 writes <name>.bin (a
    batch: <name>.<k>.bin); the other ranks check that they got None. On
    rank fail_rank the image is replaced by a 2-D array, which raises."""
    from ..encoder import encode_batch_device, encode_image_device_mesh

    for case in cases:
        kw = case.get("kwargs", {})
        if "images" in case:
            imgs = [load_image(s) for s in case["images"]]
            outs = encode_batch_device(imgs, mesh=mesh, **kw)
        else:
            img = load_image(case["image"])
            if case.get("fail_rank") == mesh.rank:
                img = img[0]
            out = encode_image_device_mesh(img, mesh=mesh, **kw)
            outs = None if out is None else [out]
        if mesh.rank != 0:
            if outs is not None:
                raise AssertionError(f"rank {mesh.rank} got bytes back")
            continue
        for k, data in enumerate(outs):
            suffix = f".{k}" if "images" in case else ""
            with open(os.path.join(out_dir, f"{case['name']}{suffix}.bin"), "wb") as f:
                f.write(data)


def multihost_entry(mesh, image, out_dir):
    """parallel.multihost's entry points on the launch's process group:
    encode_image_multihost of `image` (rank 0 writes multihost.bin; the
    other ranks check that they got None), and host0_gather of two tensors
    that differ by rank (rank 0 writes host0_gather.npz)."""
    import torch

    from ..parallel import multihost

    data = multihost.encode_image_multihost(image, device=mesh.device)
    parts = [torch.arange(5, dtype=torch.int32, device=mesh.device) + 10 * mesh.rank,
             torch.full((2, 3), mesh.rank, dtype=torch.int32, device=mesh.device)]
    host = multihost.host0_gather(parts, mesh)
    if mesh.rank != 0:
        if data is not None or host is not None:
            raise AssertionError(f"rank {mesh.rank} got results back")
        return
    _write(out_dir, "multihost.bin", data)
    np.savez(os.path.join(out_dir, "host0_gather.npz"), *host)


def host_packed_cases(mesh, image, cases, out_dir):
    """encode_image_host_packed(mesh=) of `image` in each case (name,
    kwargs): every rank writes host_<name>.rank<r>.bin (every rank returns
    the bytes); rank 0 also writes host_hist.npy, analyze_groups_sharded's
    AC histogram of the image's groups (summed over the ranks)."""
    from ..common import ImageDim, compute_distance_params
    from ..encoder import _extract_all_groups, encode_image_host_packed
    from ..parallel import sharding as SH

    img = load_image(image)
    for name, kwargs in cases:
        data = encode_image_host_packed(img, mesh=mesh, **kwargs)
        _write(out_dir, f"host_{name}.rank{mesh.rank}.bin", data)
    groups, yb, xb = _extract_all_groups(img, ImageDim(img.shape[2], img.shape[1]))
    out = SH.analyze_groups_sharded(groups, yb, xb, compute_distance_params(1.0), mesh)
    if mesh.rank == 0:
        np.save(os.path.join(out_dir, "host_hist.npy"), out["hist"])

def collective_counts(mesh, image, out_dir):
    """One encode_image_device_mesh of `image` (float32 upload, the gather
    route) with Mesh.stats() reset before it and the port's spans
    collected by a StageTimer: each rank writes counts.rank<r>.json with
    the collectives' counts and the spans' calls."""
    from ..encoder import encode_image_device_mesh
    from ..utils.profiling import StageTimer

    mesh.stats(reset=True)
    timer = StageTimer()
    with timer.collect():
        encode_image_device_mesh(load_image(image), mesh=mesh, upload_dtype=None)
    _write(out_dir, f"counts.rank{mesh.rank}.json",
           dict(stats=mesh.stats(), spans=timer.calls))


def program_outputs(mesh, image, out_dir, cap=32768, ow=8192):
    """Image-level program A and program B of the default tier on this
    rank's shard (image: [3, H, W] f32): each rank saves rank<r>.npz with
    its stream, totals, the summed hists, its dc_layout rows and the
    global `small` of program B (codes built from the hists as the encoder
    builds them)."""
    import torch

    from .. import constants as C
    from ..common import compute_distance_params
    from ..entropy.entropy_write import build_ac_device_code, build_dc_device_code
    from ..ops.pack_kernels import ac_base64_map
    from ..parallel import sharding as SH
    from ..tables import device_tables, to_device

    h, w = image.shape[1:]
    distp = compute_distance_params(1.0)
    yb, xb = SH.padded_valid_blocks(h, w, mesh.size, mesh.device)
    a = SH.analyze_image_packed_mesh(
        torch.from_numpy(image).to(mesh.device), yb, xb, distp, mesh, cap,
        device_tables(mesh.device), ysize=h, xsize=w)
    hists = a["hists"].cpu().numpy()[0]
    _, d_ac = build_ac_device_code(hists[0], ac_base64_map())
    _, d_dc = build_dc_device_code(hists[1][: C.NUM_DC_CONTEXTS])
    b = SH.pack_all_sections_mesh(
        a["stream"][:, :cap].contiguous(), a["totals"],
        to_device(np.asarray(d_ac, np.float32)[None], mesh.device), a["dc_layout"],
        to_device(np.asarray(d_dc, np.float32)[None], mesh.device), mesh, ow_ac=ow, ow_dc=ow)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"),
             **{k: a[k].cpu().numpy() for k in ("stream", "totals", "hists", "dc_layout",
                                                 "all_totals")},
             small=b["small"].cpu().numpy())


def group_programs(mesh, groups, yb, xb, out_dir, cap=32768, ow=8192):
    """analyze_groups_packed_sharded + pack_ac_sections_sharded on [G, 3,
    256, 256] groups: each rank saves rank<r>.npz (its stream, totals, the
    summed hist; its words; every rank's bits and word offsets)."""
    from ..common import compute_distance_params
    from ..entropy.entropy_write import build_ac_device_code
    from ..ops.pack_kernels import ac_base64_map
    from ..parallel import sharding as SH
    from ..tables import to_device

    out, _ = SH.analyze_groups_packed_sharded(groups, yb, xb, compute_distance_params(1.0),
                                              mesh, cap=cap)
    _, d = build_ac_device_code(out["hist"].cpu().numpy(), ac_base64_map())
    b = SH.pack_ac_sections_sharded(out["stream"][:, :cap].contiguous(), out["totals"],
                                    to_device(np.asarray(d, np.float32), mesh.device),
                                    mesh, ow)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"),
             **{k: v.cpu().numpy() for k, v in (*out.items(), *b.items())})


# ---------------------------------------------------------------------------
# Kernel calls of one rank, held against their plain versions
# ---------------------------------------------------------------------------

# The mesh encoder's programs (parallel.sharding), counted beside the
# kernels' launches: each kernel launches once a program (kernel_check.
# expected_launches; the one-pass static program is an A and a B).
MESH_PROGRAMS = ("analyze_image_packed_mesh", "pack_all_sections_mesh",
                 "analyze_pack_static_mesh")


def counted(fn):
    """fn() with the mesh programs' runs counted and every on-path kernel
    call recorded (launch counts from 0): (fn's result, calls, launches,
    runs)."""
    from ..parallel import sharding as SH

    runs, restore = KC.count_programs(SH, MESH_PROGRAMS)
    try:
        out, calls, launches = KC.recorded(fn)
    finally:
        restore()
    return out, calls, launches, runs


def _write(out_dir, name, data):
    with open(os.path.join(out_dir, name), "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data if isinstance(data, bytes) else json.dumps(data))


def _barrier(mesh):
    import torch

    mesh.psum(torch.zeros(1, device=mesh.device))


def _configs():
    from ..common import EncoderConfig

    return {"default": (None, "gather"),
            "static": (EncoderConfig(optimize_code=False), "gather"),
            "owner": (None, "owner")}


def shared_card_rank(mesh, image, out_dir, configs=("default",), record_ranks=()):
    """Ranks sharing one card (gloo): the mesh encode of `image` in each
    configuration ("default", "static", "owner": the default tier with the
    owner exchange); rank 0 writes <config>.bin. Each rank in record_ranks
    records every kernel call of one more default encode (launch counts
    from 0), holds each against its plain version and times it at its
    shard-local shape: kernels_rank<r>.json (KC.hold_calls' record, and
    the launches and mesh program runs of that encode); rank 0 writes that
    encode as recorded.bin."""
    from ..encoder import encode_image_device_mesh

    img = load_image(image)
    for name in configs:
        cfg, ex = _configs()[name]
        data = encode_image_device_mesh(img, mesh=mesh, config=cfg, dc_exchange=ex)
        if mesh.rank == 0:
            _write(out_dir, f"{name}.bin", data)
    if not record_ranks:
        return
    if mesh.rank in record_ranks:
        data, calls, launches, runs = counted(lambda: encode_image_device_mesh(img, mesh=mesh))
    else:
        data = encode_image_device_mesh(img, mesh=mesh)
    if mesh.rank == 0:
        _write(out_dir, "recorded.bin", data)
    for r in record_ranks:  # one rank at a time on the card, the others waiting
        if mesh.rank == r:
            held = KC.hold_calls(calls, time_ms=device_time)
            del calls
            _write(out_dir, f"kernels_rank{r}.json",
                   dict(held=held, launches=launches, programs=runs))
        _barrier(mesh)


def card_mesh_rank(mesh, image, crops, out_dir):
    """One rank a card (NCCL): chip_smoke.py's mesh checks of the path that
    queues without host syncs. Rank 0 writes the bytes of the default
    (launch counts from 0 before it), static and owner-exchange encodes and
    of a job of each tier queued under torch.cuda.set_sync_debug_mode(
    "error") (any host sync raises), and card.json: those launch counts,
    the walls of three mesh encodes and of three encode_image_device calls
    in this process, one job of each split into its stages, each
    collective's device time (CUDA events) and bytes at the encode's
    sizes, and whether the batch of `crops` through
    encode_batch_device(mesh=) equals the one-card batch, both tiers
    (crops: (y0, y1, x0, x1) of `image`, one size)."""
    import statistics

    import torch

    from ..encoder import (
        DeviceEncodeJob, encode_batch_device, encode_image_device, encode_image_device_mesh,
    )
    from ..parallel import sharding as SH

    img = load_image(image)
    rep = {}
    data = {}
    data["default"], _, rep["launches"], rep["programs"] = counted(
        lambda: encode_image_device_mesh(img, mesh=mesh))
    for name in ("static", "owner"):
        cfg, ex = _configs()[name]
        data[name] = encode_image_device_mesh(img, mesh=mesh, config=cfg, dc_exchange=ex)
    jobs = {}
    for name in ("default", "static"):
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            job = jobs[name] = DeviceEncodeJob([img], config=_configs()[name][0], mesh=mesh)
            torch.cuda.set_sync_debug_mode(0)
            job.pack()
            torch.cuda.set_sync_debug_mode("error")
            job._dispatch_b()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        data[f"sync_{name}"] = job.result()
    walls = {"mesh": [], "single": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        encode_image_device_mesh(img, mesh=mesh)
        torch.cuda.synchronize()
        walls["mesh"].append(time.perf_counter() - t)
        if mesh.rank == 0:
            t = time.perf_counter()
            encode_image_device(img, device=mesh.device)
            walls["single"].append(time.perf_counter() - t)
        _barrier(mesh)
    rep["walls_s"] = walls
    rep["wall_median_s"] = {k: statistics.median(v) for k, v in walls.items() if v}

    def synced_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def stages(make):
        """A job's stages on the host clock, each ending in a synchronize."""
        job, init = synced_ms(make)
        return dict(init=init, pack=synced_ms(job.pack)[1],
                    fetch=synced_ms(job._fetch_sections)[1], assembly=synced_ms(job.result)[1])

    rep["stages_ms"] = {"mesh": stages(lambda: DeviceEncodeJob([img], mesh=mesh))}
    if mesh.rank == 0:
        rep["stages_ms"]["single"] = stages(lambda: DeviceEncodeJob([img], device=mesh.device))
    _barrier(mesh)

    # The collectives at the sizes this encode gives them.
    plan, small = jobs["default"].plan, jobs["default"]._small_sync()
    gps, gd_ps = plan.ng // mesh.size, plan.ngd // mesh.size
    ac_bits, ac_offs, dc_bits, dc_offs = plan.split(small)[:4]
    words = sum(min(wcap, -(-max(plan._used_words(b, o), 1) // 65536) * 65536)
                for b, o, wcap in ((ac_bits, ac_offs, plan.wcap),
                                   (dc_bits, dc_offs, plan.wcap_dc)))
    h, w = img.shape[1:]
    _, send_counts, _, recv_counts = SH._owner_routes(
        h, w, mesh.size, gps, gd_ps, mesh.rank, mesh.device)
    dev, i32, i64 = mesh.device, torch.int32, torch.int64
    maps = torch.zeros((gps, sum(SH._MAP_SIZES)), dtype=i32, device=dev)
    sends = torch.zeros((sum(send_counts), maps.shape[1]), dtype=i32, device=dev)
    calls = {
        "psum hists [2,64,64] i64": (lambda: mesh.psum(torch.zeros((2, 64, 64), dtype=i64,
                                                                   device=dev)), 2 * 4096 * 8),
        "all_gather maps": (lambda: mesh.all_gather(maps), maps.numel() * 4),
        "all_gather totals": (lambda: mesh.all_gather(torch.zeros(gps, dtype=i64, device=dev)),
                              gps * 8),
        "all_gather small": (lambda: mesh.all_gather(torch.zeros((1, 2 * gps + 2 * gd_ps),
                                                                 dtype=i64, device=dev)),
                             (2 * gps + 2 * gd_ps) * 8),
        "exchange maps (owner)": (lambda: mesh.exchange(sends, send_counts, recv_counts),
                                  sends.numel() * 4),
        "gather0 words": (lambda: mesh.gather0(torch.zeros(words, dtype=i32, device=dev)),
                          words * 4),
    }
    rep["collectives"] = {name: dict(ms=device_time(fn, reps=20), bytes_sent_a_rank=nb)
                          for name, (fn, nb) in calls.items()}
    del maps, sends, jobs

    batch = [np.ascontiguousarray(img[:, y0:y1, x0:x1]) for y0, y1, x0, x1 in crops]
    for name in ("default", "static"):
        cfg = _configs()[name][0]
        got = encode_batch_device(batch, config=cfg, mesh=mesh)
        if mesh.rank == 0:
            ref = encode_batch_device(batch, config=cfg, device=mesh.device)
            rep[f"batch_{name}"] = dict(equal=got == ref, bytes=[len(d) for d in got])
        _barrier(mesh)
    if mesh.rank == 0:
        for name, d in data.items():
            _write(out_dir, f"{name}.bin", d[0] if isinstance(d, list) else d)
        _write(out_dir, "card.json", rep)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    p.add_argument("--exchange", default="gather", choices=("gather", "owner"))
    a = p.parse_args(argv)
    from ..encoder import encode_image_device

    img = synthetic_image()
    with tempfile.TemporaryDirectory() as out_dir:
        t = time.time()
        launch(a.ranks, encode_cases, ([dict(name="dryrun", image=img, kwargs=dict(
            upload_dtype=None, dc_exchange=a.exchange))], out_dir),
            device=a.device, backend=a.backend)
        wall = time.time() - t
        with open(os.path.join(out_dir, "dryrun.bin"), "rb") as f:
            got = f.read()
    ref = encode_image_device(img, 1.0, upload_dtype=None,
                              device="cpu" if a.device == "cpu" else None)
    if got != ref:
        print(f"multihost_dryrun: {a.ranks} ranks gave {len(got)} B, one device "
              f"{len(ref)} B", file=sys.stderr)
        return 1
    print(f"multihost_dryrun: {a.ranks} ranks on {a.device} ({a.exchange} exchange): "
          f"{len(got)} bytes, equal to the one-device encode ({wall:.1f} s with spawning)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
