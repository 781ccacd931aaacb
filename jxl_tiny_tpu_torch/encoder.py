"""Top-level encoder: image(s) -> JPEG XL codestream(s).

Counterpart of the JAX package's encoder.DeviceEncodeJob /
encode_image_device / encode_images_device / encode_batch_device /
encode_image_device_mesh, every tier of EncoderConfig, on one card or over
the ranks of a torch.distributed mesh (parallel/).

A job (DeviceEncodeJob) encodes N same-sized images, one image being
N = 1, with every kernel launching once a program over all N*G groups.

Two-pass entropy codes (optimize_code=True, the default): two device
programs and a host stage between them

  program A (ops.pipeline.analyze_batch_packed): pixels -> token stream,
      per-image base-64 histograms, DC-section layout (kernels: AQ,
      strategy estimates, quantize, tokenize, row compaction)
  host: cluster each image's histograms, build its prefix codes
      (entropy/, numpy)
  program B (ops.dc_kernels.pack_batch_sections): tokens -> section words
      (kernels: row compaction for word placement, section copy)
  host: headers, TOC and assembly (bitstream/, numpy + the native packer)

One-pass static codes (optimize_code=False): A and B run as one program
(ops.dc_kernels.analyze_pack_batch_static) with candidate code tables
trained beforehand; the device picks each image's cheapest candidates and
the host only assembles.

Queueing: neither program waits for the card while it is queued. Pixels go
up from pinned memory on an upload stream that the compute stream waits
for; every result the host reads (totals + histograms, section sizes,
section words) is copied into pinned memory on a fetch stream that waits
only for the work queued before it, and the host waits on that copy's
event. So while one job's program runs, the host can queue the next
job's upload and program A (encode_images_device), and
`ready_for_pack` can ask, without waiting, whether program A is done.

Entry points: encode_image_device (one image, one job),
encode_images_device (a pipeline of one-image jobs in input order) and
encode_batch_device (one job of N images: one upload, one histogram read,
one section read), and over a mesh encode_image_device_mesh (one image's
groups sharded over the ranks) and encode_batch_device(mesh=) (the images
sharded over the ranks); rank 0 assembles and returns the codestreams.

The capacity retries are the JAX package's own rules, kept so that the two
packages pick the same buckets: the token cap, the section word budget `ow`
checked against var_safe_words, and the fallback from the compacted word
buffer to per-group rows when the sections outgrow `wcap`.
"""
import functools
from collections import deque

import numpy as np
import torch

from . import constants as C
from .bitstream import sections as S
from .bitstream.bit_writer import BitWriter
from .common import DEFAULT_CONFIG, ImageDim, clamp_distance, compute_distance_params
from .entropy.entropy_write import (
    build_ac_device_code, build_dc_device_code, load_static_codes,
)
from .errors import InvalidInputError
from .ops.dc_kernels import analyze_pack_batch_static, pack_batch_sections
from .ops.pack_kernels import VAR_FAN, ac_base64_map, sections_wcap, var_safe_words
from .ops.pipeline import analyze_batch_packed, group_valid_blocks
from .parallel import sharding as SH
from .tables import canonical_device, device_tables, to_device
from .transfer import Fetch, read_parts, resolve_device, upload_pixels

# Below this pixel count a float16 upload is upgraded to float32: f16
# mantissa noise tilts the adaptive-quant heuristics on very flat content
# (the JAX package's rule, kept so that both packages see the same pixels).
F16_AUTO_F32_PIXELS = 2e6
_CAP_BUCKETS = (32768, 65536, 131072, 262144)
_OW_BUCKETS = (8192, 32768, 131072)

# Per-image retries that encode_images_device made in this process (a job
# re-run from its pixels after an error); chip_smoke.py requires none.
RETRY_COUNT = 0


def _upload_dtype(img_dtype, pixels, upload_dtype):
    """The type the pixels travel in: u8 stays u8 (sRGB, linearized on the
    device); float goes as upload_dtype, float32 when that is None or when
    a float16 image would be small (F16_AUTO_F32_PIXELS)."""
    if img_dtype == np.uint8:
        return np.dtype(np.uint8)
    if upload_dtype == np.float16 and pixels < F16_AUTO_F32_PIXELS:
        upload_dtype = None
    return np.dtype(np.float32 if upload_dtype is None else upload_dtype)


def _next_bucket(buckets, value):
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


@functools.lru_cache(maxsize=None)
def _static_tables(device):
    sc = load_static_codes()
    return tuple(
        to_device(a, device)
        for a in (sc.ac_tables, sc.dc_tables, sc.ac_depths, sc.dc_depths)
    )


def _static_code_tables(device):
    """(d_ac, d_dc, ac_depths, dc_depths) of the one-pass tier's candidate
    codes on `device`, uploaded once a device (read-only)."""
    return _static_tables(canonical_device(device))


# ---------------------------------------------------------------------------
# Sections and assembly
# ---------------------------------------------------------------------------


def _writer_from_bits(raw_bytes: np.ndarray, nbits: int) -> BitWriter:
    """BitWriter holding `nbits` bits whose byte image is raw_bytes (LSB
    first); trailing bits of the last partial byte are zeroed."""
    w = BitWriter()
    full = nbits // 8
    if full:
        w.write_arrays(np.full(full, 8, np.uint8), raw_bytes[:full].astype(np.uint64))
    rem = nbits & 7
    if rem:
        w.write(rem, int(raw_bytes[full]) & ((1 << rem) - 1))
    return w


def assemble_codestream(dim, distp, ac_writers, ac_code, dc_writers, dc_code) -> bytes:
    """Headers, global sections, TOC and the device-packed sections
    (ac_writers / dc_writers: one BitWriter a section)."""
    sections = []
    w = BitWriter()
    S.write_dc_global(w, distp, dim.num_dc_groups, dc_code)
    sections.append(w)
    sections.extend(dc_writers)
    w = BitWriter()
    S.write_ac_global(w, dim.num_groups, ac_code)
    sections.append(w)
    sections.extend(ac_writers)
    out = BitWriter()
    S.write_file_header(out, dim.xsize, dim.ysize)
    S.write_frame_header(out, distp.x_qm_scale, distp.epf_iters)
    S.write_toc_and_sections(out, sections)
    return out.to_bytes()


def _used_words(bits, offs):
    """Words the compacted buffer actually needs for these sections."""
    nblk = (bits + (32 * 128 - 1)) // (32 * 128)
    return int(offs[-1] + nblk[-1] * 128) if len(offs) else 0


class _SectionPlan:
    """Program B's section buffers for the ng AC and ngd DC sections of n
    images, with the JAX package's retry rules: `ow` / `ow_dc` grow until
    the largest section fits var_safe_words, and a compacted buffer that
    would outgrow its `wcap` falls back to per-section rows.

    On a mesh of `shards` ranks each rank packs ng/shards and ngd/shards
    consecutive sections into buffers of its own: `wcap` sizes one rank's
    buffer, word offsets are local to it, and the rules read every rank's
    section sizes (the all-gathered `small`), so all ranks decide alike."""

    def __init__(self, n, ng, ngd, ow, shards=1):
        self.n, self.ng, self.ngd, self.shards = n, ng, ngd, shards
        self.ow, self.ow_dc = ow, 8192
        self.compact_ac = self.compact_dc = True

    @property
    def wcap(self):
        return sections_wcap(self.ng // self.shards, self.ow)

    @property
    def wcap_dc(self):
        return sections_wcap(self.ngd // self.shards, self.ow_dc)

    def sizes(self, kernels=True):
        """Program B's size arguments."""
        return dict(
            ow_ac=self.ow, wcap_ac=self.wcap, ow_dc=self.ow_dc,
            wcap_dc=self.wcap_dc, compact_ac=self.compact_ac,
            compact_dc=self.compact_dc, kernels=kernels,
        )

    def split(self, small):
        """`small` -> (ac_bits, ac_offs, dc_bits, dc_offs, totals, k_ac,
        k_dc); the last three are the one-pass tier's and empty otherwise."""
        ends = np.cumsum([0, self.ng, self.ng, self.ngd, self.ngd, self.ng, self.n, self.n])
        return tuple(small[a:b] for a, b in zip(ends[:-1], ends[1:]))

    def _used_words(self, bits, offs):
        """Words the fullest rank's compacted buffer needs."""
        return max(_used_words(b, o) for b, o in zip(np.split(bits, self.shards),
                                                     np.split(offs, self.shards)))

    def grow(self, small) -> bool:
        """Apply the first rule that program B's section sizes break; True
        when program B must run again with the grown sizes."""
        ac_bits, ac_offs, dc_bits, dc_offs = self.split(small)[:4]
        margin = VAR_FAN + 1
        need_ac = (int(ac_bits.max(initial=0)) + 31) // 32
        if need_ac > var_safe_words(self.ow):
            self.ow = _next_bucket(_OW_BUCKETS, need_ac + margin)
            return True
        need_dc = (int(dc_bits.max(initial=0)) + 31) // 32
        if need_dc > var_safe_words(self.ow_dc):
            self.ow_dc = _next_bucket(_OW_BUCKETS, need_dc + margin)
            return True
        if self.compact_ac and self._used_words(ac_bits, ac_offs) > self.wcap:
            self.compact_ac = False
            return True
        if self.compact_dc and self._used_words(dc_bits, dc_offs) > self.wcap_dc:
            self.compact_dc = False
            return True
        return False

    def read(self, out_b, small, after=None, mesh=None):
        """Both kinds of section words in one read -> (AC writers, DC
        writers). after: the compute stream's event that program B's
        outputs are complete at (the copies then do not wait for work
        queued since). With a mesh, every rank's words are gathered to rank
        0 in one collective, and the other ranks get (None, None)."""
        ac_bits, ac_offs, dc_bits, dc_offs = self.split(small)[:4]
        kinds = ((out_b["ac_words"], ac_bits, ac_offs, self.compact_ac, self.wcap),
                 (out_b["dc_words"], dc_bits, dc_offs, self.compact_dc, self.wcap_dc))
        parts = []
        for words, bits, offs, compact, wcap in kinds:
            if compact:
                # Download word count, 65536-quantized.
                used = self._used_words(bits, offs)
                parts.append(words[: min(wcap, -(-max(used, 1) // 65536) * 65536)])
            else:
                maxw = (int(bits.max(initial=0)) + 31) // 32
                parts.append(words[:, : max(maxw, 1)])
        hosts = read_parts(parts, after, mesh)
        if hosts is None:
            return None, None
        out = []
        for words, (_, bits, offs, compact, _) in zip(hosts, kinds):
            if compact:  # [shards, dl]: section k lies in rank k // per's buffer
                per = len(bits) // self.shards
                rows = [words[k // per, offs[k]: offs[k] + (bits[k] + 31) // 32]
                        for k in range(len(bits))]
            else:  # [shards, ng / shards, maxw]: one row a section
                words = words.reshape(-1, words.shape[-1])
                rows = [np.ascontiguousarray(words[k, : (int(bits[k]) + 31) // 32])
                        for k in range(len(bits))]
            out.append([_writer_from_bits(r.view(np.uint8), int(b))
                        for r, b in zip(rows, bits)])
        return out[0], out[1]


# ---------------------------------------------------------------------------
# The job: N same-sized images (one image is N = 1)
# ---------------------------------------------------------------------------


class DeviceEncodeJob:
    """N same-sized images through the device-packed path, in one pair of
    device programs (one image: N = 1). Every kernel launches once a
    program, over all N*G groups; each image gets its own entropy codes and
    codestream. Stages:

      __init__  queues the pixel upload and program A (and the copy of its
                totals and histograms to the host); returns without waiting
      pack()    reads A's totals and histograms, builds each image's
                entropy codes, queues program B
      result()  reads the section words and assembles the N codestreams

    In the one-pass tier __init__ queues the combined program, pack() only
    checks the token capacity, and result() reads the device's candidate
    picks.

    imgs: a sequence of [3, H, W] images of one shape and one type, float
    (linear sRGB, uploaded as upload_dtype) or uint8 (sRGB samples,
    linearized on the device). device: None for the CUDA card (raises
    without one), or e.g. "cpu". tables: the encoder's tables on that
    device (default: built once a device and shared). kernels: False runs
    the plain torch versions of the kernels instead (to check the kernels
    against them on the card).

    mesh (parallel.sharding.Mesh): every rank of the mesh makes the same
    job on the same images and drives it alike; the programs run on the
    mesh's device. One image has its group axis sharded over the ranks
    (padded with empty groups to a rank multiple; dc_exchange, "gather" or
    "owner", picks how the DC layout gets its maps); N > 1 images have
    their image axis sharded (padded with zero images), whole images a
    rank. result() returns the codestreams on rank 0 and None elsewhere."""

    def __init__(self, imgs, distance=1.0, upload_dtype=np.float16, cap=32768,
                 ow=8192, config=None, device=None, tables=None, kernels=True,
                 mesh=None, dc_exchange="gather"):
        imgs = [np.asarray(im) for im in imgs]
        if not imgs or any(im.ndim != 3 or im.shape[0] != 3 for im in imgs):
            raise InvalidInputError("expected N >= 1 [3, H, W] images")
        if any(im.shape != imgs[0].shape or im.dtype != imgs[0].dtype for im in imgs):
            raise InvalidInputError("the images of a job need one shape and one type")
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.config = DEFAULT_CONFIG if config is None else config
        self.device = resolve_device(device)
        self.kernels = kernels
        self.tables = device_tables(self.device) if tables is None else tables
        self.distp = compute_distance_params(clamp_distance(distance))
        self.n, (_, h, w) = len(imgs), imgs[0].shape
        self.dim = ImageDim(w, h)
        self.cap = cap
        self.mesh, self.dc_exchange = mesh, dc_exchange
        g, gd = self.dim.num_groups, self.dim.num_dc_groups
        dtype = _upload_dtype(imgs[0].dtype, h * w, upload_dtype)
        if mesh is None:
            self._axis = None
            self.plan = _SectionPlan(self.n, self.n * g, self.n * gd, ow)
            self._yb, self._xb = group_valid_blocks(h, w, self.device, self.n)
        elif self.n == 1:
            self._axis = "groups"
            self.plan = _SectionPlan(1, SH._pad_to(g, mesh.size), SH._pad_to(gd, mesh.size),
                                     ow, shards=mesh.size)
            self._yb, self._xb = SH.padded_valid_blocks(h, w, mesh.size, self.device)
        else:
            self._axis = "images"
            lo, per, n_pad = SH.shard_images(self.n, mesh)
            imgs = (imgs + [np.zeros_like(imgs[0])] * (n_pad - self.n))[lo: lo + per]
            self._local = slice(lo, lo + per)
            self.plan = _SectionPlan(n_pad, n_pad * g, n_pad * gd, ow, shards=mesh.size)
            self._yb, self._xb = group_valid_blocks(h, w, self.device, per)
        self._up = upload_pixels(imgs, dtype, self.device)
        self._packed = False
        self._static = not self.config.optimize_code
        if self._static:
            self._static_codes = load_static_codes()
            self._d_ac, self._d_dc, self._ac_depths, self._dc_depths = (
                _static_code_tables(self.device)
            )
            self._dispatch_b()
        else:
            self._start_a()

    def _tiers(self):
        return dict(cfl=self.config.optimize_chroma_from_luma,
                    blocks=self.config.optimize_block_sizes)

    def _run_a(self, cap):
        args = (self._up, self._yb, self._xb, self.distp)
        if self._axis == "groups":
            return SH.analyze_image_packed_mesh(
                *args, self.mesh, cap, self.tables, ysize=self.dim.ysize,
                xsize=self.dim.xsize, dc_exchange=self.dc_exchange, kernels=self.kernels,
                **self._tiers())
        if self._axis == "images":
            return SH.analyze_batch_packed_mesh(*args, self.mesh, cap, self.tables,
                                                kernels=self.kernels, **self._tiers())
        return analyze_batch_packed(*args, cap, self.tables, kernels=self.kernels,
                                    **self._tiers())

    def _start_a(self):
        """Queue program A at the current cap and the copy of its totals
        and histograms (one transfer; on a mesh, every rank's) to the host."""
        self.out_a = self._run_a(self.cap)
        t = self.out_a.get("all_totals", self.out_a["totals"])
        h = self.out_a.get("all_hists", self.out_a["hists"])
        self._totals_hists = Fetch(torch.cat([t, h.reshape(-1)]))

    def _read_totals_hists(self):
        both = self._totals_hists.numpy()
        return both[: self.plan.ng], both[self.plan.ng:].reshape(-1, 2, 64, 64)

    def ready_for_pack(self) -> bool:
        """True when pack() would not wait for the card: program A's totals
        and histograms (one-pass tier: the program's section sizes) have
        reached the host. Always True on the CPU."""
        return (self._small if self._static else self._totals_hists).ready()

    def _cap_fits(self, totals) -> bool:
        """False (and the cap raised to the next bucket) when a group's
        token count overflowed the cap the program ran at."""
        if int(totals.max(initial=0)) <= self.cap:
            return True
        self.cap = _next_bucket(_CAP_BUCKETS, int(totals.max()))
        return False

    def pack(self):
        """Read program A's totals and histograms (re-running A at a larger
        token cap when a group overflowed), build each image's entropy
        codes, queue program B. Idempotent once it has succeeded. One-pass
        tier: the combined program already runs; only the token-capacity
        check remains."""
        if self._packed:
            return
        if self._static:
            if not self._cap_fits(self.plan.split(self._small_sync())[4]):
                self._dispatch_b()
            self._packed = True
            return
        totals, hists = self._read_totals_hists()
        if not self._cap_fits(totals):
            self._start_a()
            totals, hists = self._read_totals_hists()
        base_map = ac_base64_map()
        d_ac = np.empty((self.plan.n, 9, 64), np.float32)
        d_dc = np.empty((self.plan.n, 9, 64), np.float32)
        self.full_codes, self.dc_codes = [], []
        for k in range(self.plan.n):
            code, d_ac[k] = build_ac_device_code(hists[k, 0], base_map)
            self.full_codes.append(code)
            code, d_dc[k] = build_dc_device_code(hists[k, 1][: C.NUM_DC_CONTEXTS])
            self.dc_codes.append(code)
        if self._axis == "images":  # this rank's images' tables
            d_ac, d_dc = d_ac[self._local], d_dc[self._local]
        self._stream = self.out_a["stream"][:, : self.cap].contiguous()
        self._d_ac = to_device(d_ac, self.device)
        self._d_dc = to_device(d_dc, self.device)
        self._dispatch_b()
        self._packed = True

    def _dispatch_b(self):
        """Queue program B (one-pass tier: the combined program) at the
        plan's sizes, and the copy of its section sizes (on a mesh, every
        rank's) to the host."""
        sizes = self.plan.sizes(self.kernels)
        if self._static:
            args = (self._up, self._yb, self._xb, self._d_ac, self._d_dc,
                    self._ac_depths, self._dc_depths, self.distp)
            tiers = self._tiers()
            if self._axis == "groups":
                self.out_b = SH.analyze_pack_static_mesh(
                    *args, self.mesh, self.cap, self.tables, ysize=self.dim.ysize,
                    xsize=self.dim.xsize, dc_exchange=self.dc_exchange, **tiers, **sizes)
            elif self._axis == "images":
                self.out_b = SH.analyze_pack_batch_static_mesh(
                    *args, self.mesh, self.cap, self.tables, **tiers, **sizes)
            else:
                self.out_b = analyze_pack_batch_static(*args, self.cap, self.tables,
                                                       **tiers, **sizes)
        else:
            args = (self._stream, self.out_a["totals"], self._d_ac,
                    self.out_a["dc_layout"], self._d_dc)
            if self.mesh is not None:
                self.out_b = SH.pack_all_sections_mesh(*args, self.mesh, **sizes)
            else:
                self.out_b = pack_batch_sections(*args, **sizes)
        self._small = Fetch(self.out_b["small"])
        self._small_np = None
        self._sections = None

    def _small_sync(self):
        """[ac_bits, ac_offs, dc_bits, dc_offs] on the host (one-pass tier:
        followed by [totals, k_ac[N], k_dc[N]]); on a mesh, every rank's."""
        if self._small_np is None:
            self._small_np = self._small.numpy()
        return self._small_np

    def _fetch_sections(self):
        if self._sections is not None:
            return
        while self.plan.grow(self._small_sync()):
            self._dispatch_b()
        self._sections = self.plan.read(self.out_b, self._small_sync(),
                                        self._small.after, self.mesh)

    def result(self):
        """The N codestreams, in the order of the images (on a mesh: on
        rank 0, and None on the other ranks)."""
        self.pack()
        if self._static:
            # ACGlobal / DCGlobal must serialize the candidate tables the
            # device packed with; the picks are the same in every
            # re-dispatch (same histograms).
            k_ac, k_dc = self.plan.split(self._small_sync())[5:]
            self.full_codes = [self._static_codes.ac_codes[k] for k in k_ac]
            self.dc_codes = [self._static_codes.dc_codes[k] for k in k_dc]
        self._fetch_sections()
        ac_w, dc_w = self._sections
        if ac_w is None:
            return None
        g, gd = self.dim.num_groups, self.dim.num_dc_groups
        return [
            assemble_codestream(
                self.dim, self.distp, ac_w[k * g: (k + 1) * g], self.full_codes[k],
                dc_w[k * gd: (k + 1) * gd], self.dc_codes[k],
            )
            for k in range(self.n)
        ]


def encode_image_device(img: np.ndarray, distance: float = 1.0,
                        upload_dtype=np.float16, cap: int = 32768,
                        ow: int = 8192, config=None, device=None,
                        kernels=True) -> bytes:
    """Encode a [3, H, W] image on the card: float (linear sRGB, uploaded as
    upload_dtype) or uint8 (sRGB samples, linearized on the device).

    device=None runs on the CUDA card and raises without one; pass
    device="cpu" to run the plain torch versions on the CPU."""
    return DeviceEncodeJob([img], distance, upload_dtype, cap, ow, config=config,
                           device=device, kernels=kernels).result()[0]


def encode_image_device_mesh(img: np.ndarray, distance: float = 1.0, mesh=None,
                             cap: int = 32768, ow: int = 8192,
                             upload_dtype=np.float16, config=None, kernels=True,
                             dc_exchange="gather"):
    """encode_image_device over the ranks of a mesh, at full single-card
    parity (every tier, u8 / f16 / f32 ingest, the capacity retries): the
    group axis sharded over the ranks, the AC and DC histograms summed as
    integers, each rank's AC and DC sections packed on its card, the words
    gathered to rank 0. Every rank calls this with the same image. Returns
    the bytes on rank 0 (equal to encode_image_device's for any rank count)
    and None on the other ranks. mesh: None for parallel.sharding.make_mesh()
    over the initialized process group. dc_exchange: "gather" (every rank
    all-gathers the per-group maps) or "owner" (each map goes to its DC
    group's owner only); the bytes are the same."""
    if mesh is None:
        mesh = SH.make_mesh()
    out = DeviceEncodeJob([img], distance, upload_dtype, cap, ow, config=config,
                          kernels=kernels, mesh=mesh, dc_exchange=dc_exchange).result()
    return None if out is None else out[0]


# ---------------------------------------------------------------------------
# Several images
# ---------------------------------------------------------------------------


def encode_batch_device(imgs, distance: float = 1.0, upload_dtype=np.float16,
                        cap: int = 32768, ow: int = 8192, config=None,
                        device=None, kernels=True, mesh=None):
    """N same-sized images in one pair of device programs: one upload, one
    histogram read and one section read for the whole batch; each image
    gets its own entropy codes and codestream, byte-equal to
    encode_image_device of that image. Every kernel launches once a
    program, over all N*G groups. Images share one shape and one type (u8
    sRGB or float linear). With config.optimize_code=False the whole batch
    is one program (analysis, per-image candidate picks, section packing),
    with no histogram read and no host code build.

    mesh: every rank calls this with the same images; each encodes whole
    images (the image axis padded with zero images to a rank multiple), so
    the programs hold no collective (one image: its groups are sharded, as
    in encode_image_device_mesh). Returns the list on rank 0 and None on
    the other ranks."""
    return DeviceEncodeJob(imgs, distance, upload_dtype, cap, ow, config=config,
                           device=device, kernels=kernels, mesh=mesh).result()


def encode_images_device(imgs, distance=1.0, upload_dtype=np.float16, depth=3,
                         config=None, retries=1, device=None):
    """Pipelined encode of an iterable of [3, H, W] images (any sizes):
    yields each image's codestream, in input order, byte-equal to
    encode_image_device of that image.

    While the host builds image i's codes and assembles its codestream,
    images i+1 .. i+depth-1 are uploaded and their program A runs; a queued
    job whose program A has finished gets its program B queued at once
    (pack_ready). retries: how often an image whose encode raised is
    encoded again from its pixels before the error propagates (each retry
    adds one to RETRY_COUNT). The device is resolved at the call: with
    device=None and no card this raises before any image is read."""
    device = resolve_device(device)
    return _encode_pipelined(imgs, distance, upload_dtype, max(depth, 1), config,
                             retries, device)


def _encode_pipelined(imgs, distance, upload_dtype, depth, config, retries, device):
    def start(img):
        return DeviceEncodeJob([img], distance, upload_dtype, config=config, device=device)

    def finish(entry):
        global RETRY_COUNT
        job, img, err = entry
        for attempt in range(retries + 1):
            try:
                if err is not None:  # raised in pack_ready: a failed attempt
                    raise err
                if job is None:
                    job = start(img)
                job.pack()
                return job.result()[0]
            except Exception:  # any failure is retried from the pixels
                if attempt == retries:
                    raise
                RETRY_COUNT += 1
                job, err = None, None

    def pack_ready(queue):
        # A queued job whose program A has finished gets its codes built
        # and program B queued now, so that the card works through B while
        # the host assembles the image before it. An error here is kept on
        # the entry, and finish() counts it as the job's first attempt.
        for entry in queue:
            job = entry[0]
            if entry[2] is None and not job._packed and job.ready_for_pack():
                try:
                    job.pack()
                except Exception as e:  # finish() retries or re-raises it
                    entry[2] = e

    queue = deque()
    for img in imgs:
        queue.append([start(img), img, None])
        if len(queue) >= depth:
            entry = queue.popleft()
            pack_ready(queue)
            yield finish(entry)
    while queue:
        entry = queue.popleft()
        pack_ready(queue)
        yield finish(entry)
