"""Top-level encoder: image(s) -> JPEG XL codestream(s).

Counterpart of the JAX package's encoder.DeviceEncodeJob /
encode_image_device / encode_images_device / encode_batch_device /
encode_image_device_mesh, every tier of EncoderConfig, on one card or over
the ranks of a torch.distributed mesh (parallel/); and of its two
verification pipelines, three independent routes to the same quantized
image: encode_image (the numpy golden model, ref/, on the host) and
encode_image_host_packed (the JAX package's encode_image_jax: the
full-context analysis on the card, ops/pipeline_full, and the codes,
sections and packing on the host).

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
from .common import (
    DEFAULT_CONFIG, ImageDim, clamp_distance, compute_distance_params, div_ceil,
)
from .entropy import build_entropy_code
from .entropy.entropy_write import (
    build_ac_device_code, build_dc_device_code, load_static_codes,
)
from .errors import InvalidInputError
from .ops.dc_kernels import analyze_pack_batch_static, pack_batch_sections
from .ops.pack_kernels import VAR_FAN, ac_base64_map, sections_wcap, var_safe_words
from .ops import pipeline_full as PF
from .ops.pipeline import analyze_batch_packed, group_valid_blocks
from .parallel import sharding as SH
from .ref import group_np as G
from .ref import pipeline_np as P
from .tables import canonical_device, device_tables, to_device
from .transfer import Fetch, host_arrays, read_parts, resolve_device, upload_pixels

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


def assemble_codestream(groups, dim, distp, ac_ops=None, ac_histo=None,
                        ac_writers=None, ac_code=None, dc_code=None,
                        dc_writers=None) -> bytes:
    """Build the sections, optimize the entropy codes, assemble the
    codestream. groups: {(gy, gx): GroupResult} (None when both kinds of
    sections come packed).

    ac_ops: the AC sections' ops, built from groups' token arrays when
    None; ac_histo: their histogram, counted from ac_ops when None.
    ac_writers / ac_code and dc_writers / dc_code: sections packed already
    (one BitWriter a section, the device-packed path) and the codes they
    were packed with; histograms and packing are skipped for those."""
    dc_ops = []
    if dc_writers is None:
        for dgy in range(dim.ysize_dc_groups):
            for dgx in range(dim.xsize_dc_groups):
                dc_ops.append(_build_dc_group(groups, dim, dgy, dgx))
    if ac_ops is None and ac_writers is None:
        ac_ops = []
        for gy in range(dim.ysize_groups):
            for gx in range(dim.xsize_groups):
                g = groups[(gy, gx)]
                ac_ops.append(S.build_ac_group_section(g.tokens, g.counts, g.strategy,
                                                       g.is_first))
    # Two-pass entropy optimization (enc_frame.cc:846-850).
    if dc_code is None:
        dc_code = build_entropy_code(S.histogram_sections(dc_ops, C.NUM_DC_CONTEXTS))
    if ac_code is None:
        if ac_histo is None:
            ac_histo = S.histogram_sections(ac_ops, C.NUM_AC_CONTEXTS)
        ac_code = build_entropy_code(ac_histo)

    sections = []
    w = BitWriter()
    S.write_dc_global(w, distp, dim.num_dc_groups, dc_code)
    sections.append(w)
    if dc_writers is None:
        dc_writers = [S.serialize_section(ops, dc_code) for ops in dc_ops]
    sections.extend(dc_writers)
    w = BitWriter()
    S.write_ac_global(w, dim.num_groups, ac_code)
    sections.append(w)
    if ac_writers is None:
        ac_writers = [S.serialize_section(ops, ac_code) for ops in ac_ops]
    sections.extend(ac_writers)
    out = BitWriter()
    S.write_file_header(out, dim.xsize, dim.ysize)
    S.write_frame_header(out, distp.x_qm_scale, distp.epf_iters)
    S.write_toc_and_sections(out, sections)
    return out.to_bytes()


def _build_dc_group(groups, dim: ImageDim, dgy, dgx):
    """One DC group's maps, gathered from its member groups, as the ops of
    its section."""
    ydb = div_ceil(min(2048, dim.ysize - dgy * 2048), 8)
    xdb = div_ceil(min(2048, dim.xsize - dgx * 2048), 8)
    quant_dc = np.zeros((3, ydb, xdb), np.int16)
    raw_qf = np.zeros((ydb, xdb), np.uint8)
    strategy_code = np.zeros((ydb, xdb), np.int64)
    is_first = np.zeros((ydb, xdb), bool)
    ty = div_ceil(ydb * 8, 64)
    tx = div_ceil(xdb * 8, 64)
    ytox = np.zeros((ty, tx), np.int8)
    ytob = np.zeros((ty, tx), np.int8)

    gy0, gx0 = dgy * 8, dgx * 8
    for gy in range(gy0, min(gy0 + 8, dim.ysize_groups)):
        for gx in range(gx0, min(gx0 + 8, dim.xsize_groups)):
            g = groups[(gy, gx)]
            by0 = (gy - gy0) * 32
            bx0 = (gx - gx0) * 32
            quant_dc[:, by0: by0 + g.yb, bx0: bx0 + g.xb] = g.quant_dc
            raw_qf[by0: by0 + g.yb, bx0: bx0 + g.xb] = g.raw_qf
            strategy_code[by0: by0 + g.yb, bx0: bx0 + g.xb] = C.STRATEGY_CODE[g.strategy]
            is_first[by0: by0 + g.yb, bx0: bx0 + g.xb] = g.is_first
            t_y0 = (gy - gy0) * 4
            t_x0 = (gx - gx0) * 4
            gty, gtx = g.ytox.shape
            ytox[t_y0: t_y0 + gty, t_x0: t_x0 + gtx] = g.ytox
            ytob[t_y0: t_y0 + gty, t_x0: t_x0 + gtx] = g.ytob

    return S.build_dc_group_section(quant_dc, raw_qf, strategy_code, is_first, ytox, ytob)


# ---------------------------------------------------------------------------
# The numpy golden path
# ---------------------------------------------------------------------------


class GroupResult:
    """Per-group analysis outputs (cropped to the valid block dims)."""

    def __init__(self, gt, strategy, is_first, raw_qf, ytox, ytob, yb, xb):
        if gt is not None:
            self.tokens = gt.tokens[:yb, :xb]
            self.counts = gt.counts[:yb, :xb]
            self.quant_dc = gt.quant_dc[:, :yb, :xb]
        self.strategy = strategy[:yb, :xb]
        self.is_first = is_first[:yb, :xb]
        self.raw_qf = raw_qf[:yb, :xb]
        self.ytox = ytox
        self.ytob = ytob
        self.yb = yb
        self.xb = xb


def _extract_group(img, gx, gy):
    """Edge-replicated 256x256 patch (CopyAndPadImage, enc_frame.cc:597-617)."""
    _, h, w = img.shape
    ys = np.clip(gy * 256 + np.arange(256), 0, h - 1)
    xs = np.clip(gx * 256 + np.arange(256), 0, w - 1)
    return img[:, ys[:, None], xs[None, :]]


def _pad_tile_map(m):
    ty, tx = m.shape
    return np.pad(m, ((0, 4 - ty), (0, 4 - tx)), mode="edge")


def analyze_group_numpy(img, gx, gy, distp, aq_fn=None):
    """Group (gx, gy) of a [3, H, W] float image through the numpy golden
    model (ref/). aq_fn: the AQ field (default
    pipeline_np.compute_adaptive_quant_field)."""
    _, h, w = img.shape
    xb = div_ceil(min(256, w - gx * 256), 8)
    yb = div_ceil(min(256, h - gy * 256), 8)
    xyb = P.to_xyb(_extract_group(img, gx, gy))
    if aq_fn is None:
        aq_fn = P.compute_adaptive_quant_field
    qf, masking, raw_qf = aq_fn(xyb, distp.distance, distp.inv_scale)
    ytox, ytob = P.compute_cmap(xyb, xb, yb)
    ytox_p = _pad_tile_map(ytox)
    ytob_p = _pad_tile_map(ytob)
    strategy, is_first = P.compute_ac_strategy(
        xyb, qf, masking, ytox_p, ytob_p, distp.distance, xb, yb
    )
    raw_qf = P.adjust_quant_field(strategy, is_first, raw_qf)
    gt = G.encode_group(
        xyb, strategy, is_first, raw_qf, ytox_p, ytob_p, distp.scale, distp.scale_dc,
        distp.x_qm_mul, xb, yb,
    )
    return GroupResult(gt, strategy, is_first, raw_qf, ytox, ytob, yb, xb)


def _check_image(img):
    if img.ndim != 3 or img.shape[0] != 3:
        raise InvalidInputError(f"expected a [3, H, W] image, got {img.shape}")


def encode_image(img: np.ndarray, distance: float = 1.0, analyze_fn=None) -> bytes:
    """[3, H, W] float32 linear sRGB -> .jxl bytes through the numpy golden
    model on the host, group by group. analyze_fn(img, gx, gy, distp) ->
    GroupResult replaces the golden model's analysis (e.g.
    ops.pipeline_full.make_analyze_fn: one group at a time on the card)."""
    _check_image(img)
    distp = compute_distance_params(clamp_distance(distance))
    dim = ImageDim(img.shape[2], img.shape[1])
    if analyze_fn is None:
        analyze_fn = analyze_group_numpy
    groups = {(gy, gx): analyze_fn(img, gx, gy, distp)
              for gy in range(dim.ysize_groups) for gx in range(dim.xsize_groups)}
    return assemble_codestream(groups, dim, distp)


def encode_file(pfm_path, out_path, distance=1.0, analyze_fn=None) -> int:
    """encode_image of a PFM file into out_path; returns the byte count."""
    from .io.pfm import read_pfm

    data = encode_image(read_pfm(pfm_path), distance, analyze_fn=analyze_fn)
    with open(out_path, "wb") as f:
        f.write(data)
    return len(data)


# ---------------------------------------------------------------------------
# The host-packed path (the JAX package's encode_image_jax)
# ---------------------------------------------------------------------------


def _valid_blocks(dim: ImageDim):
    """(yb, xb) [G] i32 host arrays (views of group_valid_blocks' shared
    tensors: not to be written): each group's valid block rows and columns."""
    return tuple(v.numpy() for v in group_valid_blocks(dim.ysize, dim.xsize, "cpu"))


def _extract_all_groups(img, dim: ImageDim):
    """All group patches [G, 3, 256, 256] f32 (edge replicated) + valid dims."""
    groups = np.empty((dim.num_groups, 3, 256, 256), np.float32)
    i = 0
    for gy in range(dim.ysize_groups):
        for gx in range(dim.xsize_groups):
            groups[i] = _extract_group(img, gx, gy)
            i += 1
    return (groups,) + _valid_blocks(dim)


def analyze_host_packed(img, distp, mesh=None, fast=True, cap=16384, upload_dtype=None,
                        device=None, tables=None, kernels=True):
    """The device half of encode_image_host_packed: the analysis of every
    group, on the host as arrays (host_arrays). Without a mesh, or on a
    mesh of one rank with fast, the image goes up whole and is tiled on the
    device (analyze_image_fast); otherwise the groups are cut on the host
    and analyzed over the mesh (analyze_groups_sharded; without a mesh on
    one device). A fast analysis whose largest group overflows `cap` runs
    again at pipeline_full.FULL_CAP."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    tables = device_tables(device) if tables is None else tables
    dim = ImageDim(img.shape[2], img.shape[1])
    if fast and (mesh is None or mesh.size == 1):
        dtype = img.dtype if upload_dtype is None else np.dtype(upload_dtype)
        up = upload_pixels(img, dtype, device)
        yb, xb = group_valid_blocks(dim.ysize, dim.xsize, device)

        def run(c):
            return host_arrays(PF.analyze_image_fast(up, yb, xb, distp, c, tables, kernels))
    else:
        groups, yb, xb = _extract_all_groups(img, dim)
        if mesh is not None:
            def run(c):
                return SH.analyze_groups_sharded(groups, yb, xb, distp, mesh, fast, c,
                                                 tables, kernels)
        else:
            def run(c):
                return host_arrays(PF.analyze_groups(
                    to_device(groups, device), to_device(yb, device), to_device(xb, device),
                    distp, tables, kernels))
    out = run(cap)
    if fast and int(out["totals"].max(initial=0)) > cap:
        out = run(PF.FULL_CAP)
    return out


def assemble_host_packed(out, dim: ImageDim, distp, fast=True) -> bytes:
    """The host half of encode_image_host_packed: the groups' maps, the AC
    sections' ops (the streams when fast, else the per-cell token arrays),
    the histograms and codes (1980 AC contexts, clustered), serialization
    and assembly. out: analyze_host_packed's arrays; its `hist` (a mesh's
    integer sum over the ranks), where present, is the AC histogram."""
    ac_ops = None
    if fast:
        ac_ops = [[("stream", out["stream"][i, : int(out["totals"][i])])]
                  for i in range(dim.num_groups)]
    ac_histo = out["hist"].astype(np.uint32) if "hist" in out else None
    yb_arr, xb_arr = _valid_blocks(dim)
    groups = {}
    i = 0
    for gy in range(dim.ysize_groups):
        for gx in range(dim.xsize_groups):
            yb, xb = int(yb_arr[i]), int(xb_arr[i])
            ty, tx = div_ceil(yb, 8), div_ceil(xb, 8)
            gt = None if fast else G.GroupTokens(
                tokens=out["tokens"][i], counts=out["counts"][i],
                quant_dc=out["quant_dc"][i], nzeros=None)
            gr = GroupResult(gt, out["strategy"][i], out["is_first"][i], out["raw_qf"][i],
                             out["ytox"][i, :ty, :tx], out["ytob"][i, :ty, :tx], yb, xb)
            if fast:
                gr.quant_dc = out["quant_dc"][i][:, :yb, :xb]
            groups[(gy, gx)] = gr
            i += 1
    return assemble_codestream(groups, dim, distp, ac_ops=ac_ops, ac_histo=ac_histo)


def encode_image_host_packed(img: np.ndarray, distance: float = 1.0, mesh=None,
                             fast=True, cap: int = 16384, upload_dtype=None,
                             device=None, tables=None, kernels=True) -> bytes:
    """The host-packed path: every group analyzed on the card with the full
    1980-context tokens (ops/pipeline_full), the codes built, the sections
    serialized and the codestream assembled on the host: the JAX package's
    encode_image_jax (byte-equal to it on the CPU on the test images). Its
    decisions are program A's, so it holds the same quantized image as the
    device-packed path of the same upload.

    fast: only the compact emission-ordered streams (stream [G, cap]) and
    the per-block maps come back, not the token arrays; a group past `cap`
    tokens re-runs the analysis at pipeline_full.FULL_CAP. upload_dtype:
    the pixels' type on the way up (None: as given). mesh
    (parallel.sharding.Mesh): the groups sharded over its ranks, every rank
    calling this with the same image and returning the bytes. device: None
    for the CUDA card (raises without one), or e.g. "cpu". kernels: False
    runs the plain versions of the AQ and strategy kernels."""
    _check_image(img)
    distp = compute_distance_params(clamp_distance(distance))
    out = analyze_host_packed(img, distp, mesh, fast, cap, upload_dtype, device, tables,
                              kernels)
    return assemble_host_packed(out, ImageDim(img.shape[2], img.shape[1]), distp, fast)


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
            out.append([BitWriter.from_packed(r.view(np.uint8), int(b))
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
                None, self.dim, self.distp, ac_writers=ac_w[k * g: (k + 1) * g],
                ac_code=self.full_codes[k], dc_writers=dc_w[k * gd: (k + 1) * gd],
                dc_code=self.dc_codes[k],
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
