"""Multi-GPU scale-out: the group axis of one image, or the image axis of a
batch, sharded over the ranks of a torch.distributed process group.

Counterpart of the JAX package's parallel/sharding.py. There, one process
drives every device through shard_map; here every rank is a process of its
own (one a GPU, the torch idiom), and every rank calls the same function on
the same arguments (JAX's replicated P() inputs). "Sharded" outputs are
this rank's block; replicated outputs are equal on every rank.

The format is made for this: a group owns its TOC entry and its entropy
coded section, so the only couplings across groups are the integer
histogram sums (exact and order-free, so the bytes equal the single-card
encode's for any rank count) and the DC layout, whose DC groups span 8x8
AC groups (enc_frame.cc:536-570). The collectives (Mesh's methods) are:

  psum        integer sum of the AC and DC histograms (int64)
  all_gather  the per-group maps for the DC layout, the totals, and the
              section sizes (`small`), tiled on dim 0
  exchange    the DC owner exchange: each group's maps go to the one rank
              that owns its DC group (one all_to_all_single)
  gather0     the section words, to rank 0, which assembles the codestream

Every decision the host takes (the token-cap retry, the growth of ow and
ow_dc, the compacted-buffer fallback) reads all-gathered or all-reduced
values, so that all ranks take it together and queue the same collectives.

Each method opens the span mesh.<method> (utils/profiling.span: off unless
a profiler records or a StageTimer collects) and counts its calls and the
bytes it moves over this rank's links (Mesh.stats()).
"""
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from ..common import div_ceil
from ..constants import DC_PAD
from ..ops import dc_kernels as DK
from ..ops import pipeline as PL
from ..ops import pipeline_full as PF
from ..ops.pack_kernels import pack_ac_sections, sections_wcap
from ..tables import canonical_device, device_tables, to_device
from ..transfer import host_arrays, resolve_device
from ..utils.profiling import span

# The DC layout's padding entry (PAD << 16) as the int32 pattern the
# port's layouts hold.
_PAD_ENTRY = int(np.array(DC_PAD << 16, np.uint32).view(np.int32))
# Per-group maps the DC layout is built from, flattened into one int32 row
# a group for the exchange: quant_dc [3,32,32], raw_qf, strategy, is_first
# [32,32], ytox, ytob [4,4].
_MAP_SHAPES = ((3, 32, 32), (32, 32), (32, 32), (32, 32), (4, 4), (4, 4))
_MAP_SIZES = tuple(int(np.prod(s)) for s in _MAP_SHAPES)


class Mesh:
    """The ranks of a process group on one axis ("g", as the JAX package's
    mesh) and this rank's device. Its methods are the only collectives the
    scale-out uses; each takes and returns tensors on `device`.

    The backend is NCCL for CUDA tensors and gloo for CPU ones. Ranks that
    share one card (which NCCL refuses) use gloo on CUDA tensors, which
    gloo copies through host memory and so waits for the card: such a
    group is a correctness check, not a path that queues without host
    syncs.

    stats() holds, for each method, its calls and the bytes this rank
    sends and receives in them, counted as the least any algorithm moves:
    all_reduce of S bytes 2(n-1)S/n each way (rounded down), all_gather
    (n-1) times the rank's part each way, all_to_all_single the rows to
    and from the other ranks, gather to rank 0 the part sent (rank 0: n-1
    parts received)."""

    def __init__(self, device, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        self._root = 0 if group is None else dist.get_global_rank(group, 0)
        self._stats = {}

    def _count(self, name, sent, received):
        s = self._stats.setdefault(name, dict(calls=0, sent=0, received=0))
        s["calls"] += 1
        s["sent"] += sent
        s["received"] += received

    def stats(self, reset=False):
        """{method: dict(calls, sent, received)} since the mesh was made or
        last reset (reset=True returns the counts and zeroes them)."""
        out = {k: dict(v) for k, v in self._stats.items()}
        if reset:
            self._stats.clear()
        return out

    def psum(self, t):
        """Integer sum over the ranks, in int64 (exact, in any order)."""
        with span("mesh.psum"):
            x = t.to(torch.int64, copy=True).contiguous()
            moved = 2 * (self.size - 1) * x.numel() * x.element_size() // self.size
            self._count("psum", moved, moved)
            dist.all_reduce(x, group=self.group)
            return x

    def all_gather(self, t):
        """The ranks' tensors (one shape on every rank) concatenated on dim 0
        in rank order (jax.lax.all_gather(..., tiled=True))."""
        with span("mesh.all_gather"):
            x = t.contiguous()
            moved = (self.size - 1) * x.numel() * x.element_size()
            self._count("all_gather", moved, moved)
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts)

    def exchange(self, send, send_counts, recv_counts):
        """all_to_all_single on dim 0: send_counts[s] rows of `send` go to
        rank s, in rank order; recv_counts[q] rows come from rank q."""
        with span("mesh.exchange"):
            x = send.contiguous()
            row = int(np.prod(x.shape[1:])) * x.element_size()
            self._count("exchange", row * (sum(send_counts) - send_counts[self.rank]),
                        row * (sum(recv_counts) - recv_counts[self.rank]))
            out = x.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
            dist.all_to_all_single(out, x, list(recv_counts), list(send_counts),
                                   group=self.group)
            return out

    def gather0(self, t):
        """The ranks' tensors (one shape) stacked [size, ...] on rank 0; None
        on the other ranks."""
        with span("mesh.gather0"):
            x = t.contiguous()
            part = x.numel() * x.element_size()
            if self.rank == 0:
                self._count("gather0", 0, (self.size - 1) * part)
                parts = [torch.empty_like(x) for _ in range(self.size)]
            else:
                self._count("gather0", part, 0)
                parts = None
            dist.gather(x, parts, dst=self._root, group=self.group)
            return None if parts is None else torch.stack(parts)


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh over an initialized process group (parallel.multihost.
    initialize, or torchrun's env:// with init_process_group). device:
    None for this rank's CUDA card (LOCAL_RANK, else the rank modulo the
    card count; raises without a card), or e.g. "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(parallel.multihost.initialize, or torchrun)"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank(group)
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    return Mesh(dev, group)


# ---------------------------------------------------------------------------
# Geometry (host, numpy)
# ---------------------------------------------------------------------------


def _pad_to(n, m):
    return -(-n // m) * m


def _mesh_geometry(ysize, xsize, gpad, n):
    """Group-grid geometry of the image-level programs: (G, groups a
    shard, Gd, Gd padded to a rank multiple, DC groups a shard)."""
    g_img = div_ceil(ysize, 256) * div_ceil(xsize, 256)
    if gpad % n or gpad < g_img:
        raise ValueError(f"{gpad} padded groups do not fit {g_img} groups on {n} ranks")
    gd_img = div_ceil(ysize, 2048) * div_ceil(xsize, 2048)
    gd_pad = _pad_to(gd_img, n)
    return g_img, gpad // n, gd_img, gd_pad, gd_pad // n


@functools.lru_cache(maxsize=None)
def _dc_owner_tables(ysize, xsize, n_shards, gps, gd_ps):
    """Static routing of the DC owner exchange: every AC group's maps are
    needed by exactly one shard, the owner of its DC group, so each map
    moves once instead of to every rank.

    Returns (deltas tuple, sel [n_shards, len(deltas), gd_ps*64] i32):
    sel[s, di, m] = the source-local row of member m's group when its
    source shard is (s - deltas[di]) % n_shards, else -1. Member order:
    m = local_dc * 64 + my * 8 + mx. (The JAX package moves the maps in
    one ppermute ring round a delta; the port moves them in one
    all_to_all_single with the same routing.)"""
    ygr, xgr = div_ceil(ysize, 256), div_ceil(xsize, 256)
    ydg, xdg = div_ceil(ysize, 2048), div_ceil(xsize, 2048)
    gd_img = ydg * xdg
    m_tot = gd_ps * 64
    need = np.full((n_shards, m_tot), -1, np.int64)
    for s in range(n_shards):
        for dl in range(gd_ps):
            d = s * gd_ps + dl
            if d >= gd_img:
                continue
            dy, dx = d // xdg, d % xdg
            for my in range(8):
                gy = dy * 8 + my
                if gy >= ygr:
                    continue
                for mx in range(8):
                    gx = dx * 8 + mx
                    if gx < xgr:
                        need[s, dl * 64 + my * 8 + mx] = gy * xgr + gx
    src = np.where(need >= 0, need // gps, -1)
    deltas = sorted(
        {
            int((s - src[s, m]) % n_shards)
            for s in range(n_shards)
            for m in range(m_tot)
            if src[s, m] >= 0
        }
    )
    sel = np.full((n_shards, max(len(deltas), 1), m_tot), -1, np.int32)
    for s in range(n_shards):
        for di, dlt in enumerate(deltas):
            match = (src[s] >= 0) & (src[s] == (s - dlt) % n_shards)
            sel[s, di, match] = (need[s, match] % gps).astype(np.int32)
    return tuple(deltas), sel


@functools.lru_cache(maxsize=64)
def _owner_routes(ysize, xsize, n, gps, gd_ps, rank, device):
    """This rank's side of the owner exchange, from _dc_owner_tables: (the
    local rows it sends, in destination order, as an index on `device`;
    rows to each rank; the member slots of what it receives, in source
    order, as an index on `device`; rows from each rank)."""
    deltas, sel = _dc_owner_tables(ysize, xsize, n, gps, gd_ps)

    def route(dst, src):  # (member slots, source-local rows) that src sends dst
        dlt = (dst - src) % n
        if dlt not in deltas:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        row = sel[dst, deltas.index(dlt)]
        slots = np.flatnonzero(row >= 0)
        return slots, row[slots].astype(np.int64)

    send = [route(s, rank)[1] for s in range(n)]
    recv = [route(rank, q)[0] for q in range(n)]
    return (to_device(np.concatenate(send), device), [len(a) for a in send],
            to_device(np.concatenate(recv), device), [len(a) for a in recv])


@functools.lru_cache(maxsize=64)
def _padded_valid_blocks(ysize, xsize, n, device):
    g = div_ceil(ysize, 256) * div_ceil(xsize, 256)
    pad = _pad_to(g, n) - g
    return tuple(
        to_device(np.concatenate([v.cpu().numpy(), np.zeros(pad, np.int32)]), device)
        for v in PL.group_valid_blocks(ysize, xsize, "cpu")
    )


def padded_valid_blocks(ysize, xsize, n, device):
    """(yb_pad, xb_pad) [Gpad] i32: group_valid_blocks padded with empty
    groups (zero valid blocks) to a multiple of n. Made once a size, rank
    count and device (read-only)."""
    return _padded_valid_blocks(ysize, xsize, n, canonical_device(device))


def shard_groups(groups, yb_valid, xb_valid, mesh: Mesh):
    """Pad G to a rank multiple (zero pixels, zero valid blocks) and take
    this rank's block of the group axis, on the mesh's device. Returns
    (groups, yb_valid, xb_valid, G)."""
    groups = torch.as_tensor(groups)
    g = groups.shape[0]
    gps = _pad_to(g, mesh.size) // mesh.size
    lo, hi = min(mesh.rank * gps, g), min((mesh.rank + 1) * gps, g)

    def block(a):
        a = torch.as_tensor(a)[lo:hi].to(mesh.device)
        if hi - lo == gps:
            return a
        return torch.cat([a, a.new_zeros((gps - (hi - lo),) + tuple(a.shape[1:]))])

    return block(groups), block(yb_valid), block(xb_valid), g


def analyze_groups_sharded(groups, yb_valid, xb_valid, distp, mesh: Mesh, fast=False,
                           cap=16384, tables=None, kernels=True):
    """The full-context analysis (ops/pipeline_full: analyze_groups_fast
    when fast, else analyze_groups) of [G, 3, 256, 256] host groups, the
    group axis sharded over the mesh (shard_groups). Every rank gets every
    group's outputs as host arrays (transfer.host_arrays), all-gathered and
    cut to G, and `hist`, the AC histogram [1980, 64] summed over the
    ranks (an integer sum: equal to one device's for any rank count)."""
    gs, ybs, xbs, g = shard_groups(groups, yb_valid, xb_valid, mesh)
    tables = device_tables(mesh.device) if tables is None else tables
    if fast:
        out = PF.analyze_groups_fast(gs, ybs, xbs, distp, cap, tables, kernels,
                                     with_hist=True)
    else:
        out = PF.analyze_groups(gs, ybs, xbs, distp, tables, kernels, with_hist=True)
    hist = mesh.psum(out.pop("hist"))
    # Gathered as int32: gloo refuses int16 (quant_dc).
    full = {k: mesh.all_gather(v.to(torch.int32))[:g].to(v.dtype) for k, v in out.items()}
    return dict(host_arrays(full), hist=hist.cpu().numpy())


# ---------------------------------------------------------------------------
# The DC layout of this rank's DC groups
# ---------------------------------------------------------------------------


def _pack_maps(maps):
    """The six per-group maps -> one [G, 6176] int32 row a group."""
    g = maps[0].shape[0]
    return torch.cat([m.reshape(g, -1).to(torch.int32) for m in maps], dim=1)


def _unpack_maps(rows):
    parts = torch.split(rows, _MAP_SIZES, dim=1)
    maps = [p.reshape((rows.shape[0],) + s) for p, s in zip(parts, _MAP_SHAPES)]
    maps[3] = maps[3].to(torch.bool)
    return maps


def _mosaic(a, gd_ps):
    """Member-ordered [gd_ps*64, (C,) t, t] -> DC-group planes [gd_ps, (C,)
    8t, 8t] (regroup_dc's tile order)."""
    t = a.shape[-1]
    if a.dim() == 4:
        c = a.shape[1]
        v = a.reshape(gd_ps, 8, 8, c, t, t).permute(0, 3, 1, 4, 2, 5)
        return v.reshape(gd_ps, c, 8 * t, 8 * t)
    v = a.reshape(gd_ps, 8, 8, t, t).permute(0, 1, 3, 2, 4)
    return v.reshape(gd_ps, 8 * t, 8 * t)


def _dc_layout_owner_exchange(maps, mesh, ysize, xsize, gps, gd_ps):
    """This rank's DC-group planes [gd_ps, ...] from the owner exchange:
    each rank receives only its DC groups' member maps and places them by
    member slot (members outside the image stay zero, as the all-gather
    route's padding)."""
    send_idx, send_counts, recv_pos, recv_counts = _owner_routes(
        ysize, xsize, mesh.size, gps, gd_ps, mesh.rank, canonical_device(mesh.device)
    )
    rows = _pack_maps(maps)
    recv = mesh.exchange(rows.index_select(0, send_idx), send_counts, recv_counts)
    acc = rows.new_zeros((gd_ps * 64, rows.shape[1]))
    acc.index_copy_(0, recv_pos, recv)
    return [_mosaic(m, gd_ps) for m in _unpack_maps(acc)]


def _dc_layout_gather(maps, mesh, ysize, xsize, g_img, gd_lo, gd_hi):
    """This rank's DC-group planes from all the ranks' maps (the JAX
    package's default route): all-gather, regroup, keep this rank's."""
    full = _unpack_maps(mesh.all_gather(_pack_maps(maps))[:g_img])
    return [p[gd_lo:gd_hi] for p in PL.dc_planes(*full, ysize=ysize, xsize=xsize)]


def _my_dc_layout(maps, mesh, ysize, xsize, gpad, tables, dc_exchange):
    """[gd_ps, DC_CAP] i32: the layout of this rank's DC groups; rows of
    padding DC groups (beyond the image's) hold the padding entry."""
    g_img, gps, gd_img, _, gd_ps = _mesh_geometry(ysize, xsize, gpad, mesh.size)
    gd_lo = mesh.rank * gd_ps
    n_real = max(0, min(gd_ps, gd_img - gd_lo))
    if dc_exchange == "owner":
        planes = [p[:n_real] for p in
                  _dc_layout_owner_exchange(maps, mesh, ysize, xsize, gps, gd_ps)]
    elif dc_exchange == "gather":
        planes = _dc_layout_gather(maps, mesh, ysize, xsize, g_img, gd_lo, gd_lo + n_real)
    else:
        raise ValueError(f"dc_exchange must be 'gather' or 'owner', not {dc_exchange!r}")
    parts = []
    if n_real:
        geo = PL.dc_geometry(ysize, xsize, maps[0].device)
        parts.append(DK.build_dc_layout(
            *planes, *(v[gd_lo:gd_lo + n_real] for v in geo), tables))
    if n_real < gd_ps:
        parts.append(torch.full((gd_ps - n_real, DK.DC_CAP), _PAD_ENTRY,
                                dtype=torch.int32, device=maps[0].device))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _gather_small(mesh, local, sizes, replicated=0):
    """Every rank's `small` [fields..., replicated tail] -> the global
    layout: each field concatenated over the ranks in rank order (word
    offsets stay shard-local), then the tail of rank 0 (equal on every
    rank)."""
    rows = mesh.all_gather(local[None])
    parts, start = [], 0
    for s in sizes:
        parts.append(rows[:, start:start + s].reshape(-1))
        start += s
    if replicated:
        parts.append(rows[0, start:start + replicated])
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Group-level entry points
# ---------------------------------------------------------------------------


def analyze_groups_packed_sharded(groups, yb_valid, xb_valid, distp, mesh: Mesh,
                                  cap=32768, cfl=True, blocks=True, tables=None,
                                  kernels=True):
    """Program A's group core on this rank's block of the group axis (G
    padded to a rank multiple), with the base-64 histogram summed over the
    ranks. Returns (dict(stream [G/n, cap+128], totals [G/n] this rank's,
    hist [64, 64] i64 summed), G)."""
    tables = device_tables(mesh.device) if tables is None else tables
    gr, yb, xb, g = shard_groups(groups, yb_valid, xb_valid, mesh)
    out = PL.analyze_groups_packed(gr, yb, xb, distp, cap, tables, cfl, blocks, kernels)
    out.pop("maps")
    out["hist"] = mesh.psum(out["hist"][0])
    return out, g


def pack_ac_sections_sharded(stream, totals, d_table, mesh: Mesh, ow=8192,
                             kernels=True):
    """Program B's AC sections of this rank's groups (stream [G/n, cap],
    totals [G/n]) into a buffer of its own. Returns dict(words [wcap] this
    rank's, bits [G] and word_offs [G] of every rank, offsets local to each
    rank's buffer)."""
    gps = stream.shape[0]
    out = pack_ac_sections(stream, totals, d_table, ow, sections_wcap(gps, ow),
                           kernels=kernels)
    both = _gather_small(mesh, torch.cat([out["bits"], out["word_offs"]]), (gps, gps))
    return dict(words=out["words"], bits=both[: gps * mesh.size],
                word_offs=both[gps * mesh.size:])


# ---------------------------------------------------------------------------
# One image, its group axis sharded
# ---------------------------------------------------------------------------


def _analysis_shard_body(image, yb_pad, xb_pad, distp, mesh, cap, tables, cfl,
                         blocks, ysize, xsize, kernels, dc_exchange):
    """This rank's part of image-level program A: device tiling of the
    replicated image (u8 / f16 / f32, the single-card extract_groups_device),
    its block of the group axis through the analysis and the compaction,
    its DC groups' layout, and the AC and DC histograms summed over the
    ranks. Returns dict(stream, totals, hists [1, 2, 64, 64], dc_layout)."""
    gpad = yb_pad.shape[0]
    g_img, gps, *_ = _mesh_geometry(ysize, xsize, gpad, mesh.size)
    lo = mesh.rank * gps
    groups = PL.extract_groups_device(image)[min(lo, g_img):min(lo + gps, g_img)]
    if groups.shape[0] < gps:
        groups = torch.cat([groups, groups.new_zeros((gps - groups.shape[0], 3, 256, 256))])
    out = PL.analyze_groups_packed(groups, yb_pad[lo:lo + gps], xb_pad[lo:lo + gps], distp,
                                   cap, tables, cfl, blocks, kernels)
    my_dc = _my_dc_layout(out["maps"], mesh, ysize, xsize, gpad, tables, dc_exchange)
    hists = mesh.psum(torch.cat([out["hist"], DK.dc_hist(my_dc)]))
    return dict(stream=out["stream"], totals=out["totals"], hists=hists[None],
                dc_layout=my_dc)


def analyze_image_packed_mesh(image, yb_pad, xb_pad, distp, mesh: Mesh, cap, tables,
                              cfl=True, blocks=True, ysize=None, xsize=None,
                              kernels=True, dc_exchange="gather"):
    """Image-level program A over the mesh, at single-card parity. image:
    [3, H, W] or [1, 3, H, W] on the mesh's device, the same on every rank;
    yb_pad / xb_pad: [Gpad] valid block dims padded to a rank multiple
    (padded_valid_blocks). dc_exchange: "gather" (all-gather the maps) or
    "owner" (each map to its DC group's owner); both give the same layout.

    Returns dict(stream [Gpad/n, cap+128], totals [Gpad/n], dc_layout
    [Gd_pad/n, DC_CAP] this rank's; hists [1, 2, 64, 64] i64 and
    all_totals [Gpad], equal on every rank)."""
    out = _analysis_shard_body(image, yb_pad, xb_pad, distp, mesh, cap, tables, cfl,
                               blocks, ysize, xsize, kernels, dc_exchange)
    out["all_totals"] = mesh.all_gather(out["totals"])
    return out


def analyze_pack_static_mesh(image, yb_pad, xb_pad, d_ac, d_dc, ac_depths, dc_depths,
                             distp, mesh: Mesh, cap, tables, cfl, blocks, ow_ac,
                             wcap_ac, ow_dc, wcap_dc, compact_ac=True,
                             compact_dc=True, ysize=None, xsize=None, kernels=True,
                             dc_exchange="gather"):
    """The one-pass static tier over the mesh: analysis and section packing
    with static code tables in one program. The candidate picks run on the
    summed histograms, so every rank picks the same tables. wcap_ac /
    wcap_dc size each rank's own buffers.

    Returns dict(ac_words, dc_words this rank's; small = [ac_bits, ac_offs,
    dc_bits, dc_offs, totals] of every rank (offsets shard-local), then
    [k_ac, k_dc], equal on every rank)."""
    a = _analysis_shard_body(image, yb_pad, xb_pad, distp, mesh, cap, tables, cfl,
                             blocks, ysize, xsize, kernels, dc_exchange)
    k_ac = DK.select_code_table(a["hists"][:, 0], ac_depths)
    k_dc = DK.select_code_table(a["hists"][:, 1], dc_depths)
    b = DK.pack_batch_sections(
        a["stream"][:, :cap].contiguous(), a["totals"], d_ac.index_select(0, k_ac),
        a["dc_layout"], d_dc.index_select(0, k_dc), ow_ac=ow_ac, wcap_ac=wcap_ac,
        ow_dc=ow_dc, wcap_dc=wcap_dc, compact_ac=compact_ac, compact_dc=compact_dc,
        kernels=kernels,
    )
    gps, gd_ps = a["totals"].shape[0], a["dc_layout"].shape[0]
    b["small"] = _gather_small(mesh, torch.cat([b["small"], a["totals"], k_ac, k_dc]),
                               (gps, gps, gd_ps, gd_ps, gps), replicated=2)
    return b


def pack_all_sections_mesh(stream, totals, d_ac, dc_layout, d_dc, mesh: Mesh, ow_ac,
                           ow_dc, wcap_ac=None, wcap_dc=None, compact_ac=True,
                           compact_dc=True, kernels=True):
    """Program B over the mesh: this rank's AC and DC sections into buffers
    of its own (wcap_ac / wcap_dc: None for the size rule on this rank's
    section count). Sharded on the group axis: stream [Gpad/n, cap],
    dc_layout [Gd_pad/n, DC_CAP], d_ac / d_dc [1, 9, 64]; on the image axis
    (the JAX package's pack_batch_sections_mesh; one image is a batch of
    one here, so the same function serves): this rank's images' streams,
    layouts and tables [N/n, 9, 64]. Returns dict(ac_words, dc_words this
    rank's; small = [ac_bits, ac_offs, dc_bits, dc_offs] of every rank,
    offsets shard-local)."""
    gps, gd_ps = stream.shape[0], dc_layout.shape[0]
    wcap_ac = sections_wcap(gps, ow_ac) if wcap_ac is None else wcap_ac
    wcap_dc = sections_wcap(gd_ps, ow_dc) if wcap_dc is None else wcap_dc
    b = DK.pack_batch_sections(stream, totals, d_ac, dc_layout, d_dc, ow_ac=ow_ac,
                               wcap_ac=wcap_ac, ow_dc=ow_dc, wcap_dc=wcap_dc,
                               compact_ac=compact_ac, compact_dc=compact_dc,
                               kernels=kernels)
    b["small"] = _gather_small(mesh, b["small"], (gps, gps, gd_ps, gd_ps))
    return b


# ---------------------------------------------------------------------------
# A batch, its image axis sharded: no collective inside the programs
# ---------------------------------------------------------------------------


def shard_images(n_images, mesh: Mesh):
    """The image axis padded to a rank multiple: (this rank's first image,
    its image count, the padded N). Images from N on are padding (zero
    pixels)."""
    per = _pad_to(n_images, mesh.size) // mesh.size
    return mesh.rank * per, per, per * mesh.size


def analyze_batch_packed_mesh(batch, yb_valid, xb_valid, distp, mesh: Mesh, cap,
                              tables, cfl=True, blocks=True, kernels=True):
    """Batched program A on this rank's images (batch [N/n, 3, H, W];
    yb_valid / xb_valid [N/n * G]): whole images a rank, so the analysis
    has no collective. Returns analyze_batch_packed's dict (this rank's)
    with all_totals [N*G] and all_hists [N, 2, 64, 64] of every rank, for
    the host's retry decision and entropy codes."""
    a = PL.analyze_batch_packed(batch, yb_valid, xb_valid, distp, cap, tables, cfl,
                                blocks, kernels)
    ng = a["totals"].shape[0]
    rows = mesh.all_gather(torch.cat([a["totals"], a["hists"].reshape(-1)])[None])
    a["all_totals"] = rows[:, :ng].reshape(-1)
    a["all_hists"] = rows[:, ng:].reshape((-1,) + tuple(a["hists"].shape[1:]))
    return a


def analyze_pack_batch_static_mesh(batch, yb_valid, xb_valid, d_ac, d_dc, ac_depths,
                                   dc_depths, distp, mesh: Mesh, cap, tables, cfl,
                                   blocks, ow_ac, wcap_ac, ow_dc, wcap_dc,
                                   compact_ac=True, compact_dc=True, kernels=True):
    """The one-pass batch tier on this rank's images: no collective inside
    (each image's histograms, picks and sections are its own). `small` as
    analyze_pack_batch_static's, of every rank: [ac_bits, ac_offs, dc_bits,
    dc_offs, totals, k_ac[N], k_dc[N]]."""
    b = DK.analyze_pack_batch_static(
        batch, yb_valid, xb_valid, d_ac, d_dc, ac_depths, dc_depths, distp, cap,
        tables, cfl, blocks, ow_ac, wcap_ac, ow_dc, wcap_dc, compact_ac, compact_dc,
        kernels,
    )
    n_img, ng = batch.shape[0], b["totals"].shape[0]
    ngd = b["dc_bits"].shape[0]
    b["small"] = _gather_small(mesh, b["small"], (ng, ng, ngd, ngd, ng, n_img, n_img))
    return b
