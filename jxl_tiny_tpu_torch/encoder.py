"""Top-level encoder: image -> JPEG XL codestream.

Counterpart of the JAX package's encoder.DeviceEncodeJob /
encode_image_device, single device, every tier of EncoderConfig.

Two-pass entropy codes (optimize_code=True, the default): two device
programs and a host stage between them

  program A (ops.pipeline.analyze_image_packed): pixels -> token stream,
      base-64 histograms, DC-section layout (kernels: AQ, strategy
      estimates, quantize, tokenize, row compaction)
  host: cluster the histograms, build the prefix codes (entropy/, numpy)
  program B (ops.dc_kernels.pack_all_sections): tokens -> section words
      (kernels: row compaction for word placement, section copy)
  host: headers, TOC and assembly (bitstream/, numpy)

One-pass static codes (optimize_code=False): A and B run as one program
(ops.dc_kernels.analyze_pack_static) with candidate code tables trained
beforehand; the device picks the cheapest candidates and the host only
assembles.

The capacity retries are the JAX package's own rules, kept so that the two
packages pick the same buckets: the token cap, the section word budget `ow`
checked against var_safe_words, and the fallback from the compacted word
buffer to per-group rows when the sections outgrow `wcap`.
"""
import numpy as np
import torch

from . import constants as C
from .bitstream import sections as S
from .bitstream.bit_writer import BitWriter
from .common import DEFAULT_CONFIG, ImageDim, clamp_distance, compute_distance_params, div_ceil
from .entropy.entropy_write import (
    build_ac_device_code, build_dc_device_code, load_static_codes,
)
from .errors import InvalidInputError
from .ops.dc_kernels import analyze_pack_static, pack_all_sections
from .ops.pack_kernels import VAR_FAN, ac_base64_map, var_safe_words
from .ops.pipeline import analyze_image_packed
from .tables import numpy_tables, tables_from_numpy

# Below this pixel count a float16 upload is upgraded to float32: f16
# mantissa noise tilts the adaptive-quant heuristics on very flat content
# (the JAX package's rule, kept so that both packages see the same pixels).
F16_AUTO_F32_PIXELS = 2e6
_CAP_BUCKETS = (32768, 65536, 131072, 262144)
_OW_BUCKETS = (8192, 32768, 131072)


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; without one, raise rather than fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain torch "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _next_bucket(buckets, value):
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


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
    """Headers, global sections, TOC and the device-packed sections.
    ac_writers/dc_writers: callables returning the per-group BitWriters."""
    sections = []
    w = BitWriter()
    S.write_dc_global(w, distp, dim.num_dc_groups, dc_code)
    sections.append(w)
    sections.extend(dc_writers())
    w = BitWriter()
    S.write_ac_global(w, dim.num_groups, ac_code)
    sections.append(w)
    sections.extend(ac_writers())
    out = BitWriter()
    S.write_file_header(out, dim.xsize, dim.ysize)
    S.write_frame_header(out, distp.x_qm_scale, distp.epf_iters)
    S.write_toc_and_sections(out, sections)
    return out.to_bytes()


class DeviceEncodeJob:
    """One image through the device-packed path. Stages:

      __init__  uploads the pixels and runs program A
      pack()    reads A's totals and histograms, builds the entropy codes,
                runs program B
      result()  reads the section words and assembles the codestream

    In the one-pass tier __init__ runs the combined program, pack() only
    checks the token capacity, and result() reads the device's candidate
    picks.

    device: None for the CUDA card (raises without one), or e.g. "cpu".
    kernels: False runs the plain torch versions of the kernels instead
    (to check the kernels against them on the card)."""

    def __init__(self, img, distance=1.0, upload_dtype=np.float16, cap=32768,
                 ow=8192, config=None, device=None, tables=None, kernels=True):
        if img.ndim != 3 or img.shape[0] != 3:
            raise InvalidInputError(f"expected a [3, H, W] image, got {img.shape}")
        self.config = DEFAULT_CONFIG if config is None else config
        self.device = resolve_device(device)
        self.kernels = kernels
        self.tables = (
            tables_from_numpy(numpy_tables(), self.device) if tables is None else tables
        )
        distance = clamp_distance(distance)
        self.distp = compute_distance_params(distance)
        self.dim = ImageDim(img.shape[2], img.shape[1])
        self.cap = cap
        self.ow = ow
        self._ow_dc = 8192
        yb = [div_ceil(min(256, img.shape[1] - gy * 256), 8)
              for gy in range(self.dim.ysize_groups) for _ in range(self.dim.xsize_groups)]
        xb = [div_ceil(min(256, img.shape[2] - gx * 256), 8)
              for _ in range(self.dim.ysize_groups) for gx in range(self.dim.xsize_groups)]
        self._yb = torch.tensor(yb, dtype=torch.int32, device=self.device)
        self._xb = torch.tensor(xb, dtype=torch.int32, device=self.device)
        if img.dtype != np.uint8:  # uint8 is sRGB, linearized on the device
            if (upload_dtype == np.float16
                    and img.shape[1] * img.shape[2] < F16_AUTO_F32_PIXELS):
                upload_dtype = None
            img = img.astype(np.float32 if upload_dtype is None else upload_dtype)
        self._up = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        self._compact_ac = True
        self._compact_dc = True
        self._packed = False
        self._static = not self.config.optimize_code
        if self._static:
            self._static_codes = sc = load_static_codes()

            def dev(a):
                return torch.from_numpy(a).to(self.device)

            self._d_ac, self._d_dc = dev(sc.ac_tables), dev(sc.dc_tables)
            self._ac_depths, self._dc_depths = dev(sc.ac_depths), dev(sc.dc_depths)
            self._dispatch_b()
        else:
            self.out_a = self._run_a(self.cap)

    def _run_a(self, cap):
        return analyze_image_packed(
            self._up, self._yb, self._xb, self.distp, cap, self.tables,
            cfl=self.config.optimize_chroma_from_luma,
            blocks=self.config.optimize_block_sizes, kernels=self.kernels,
        )

    def _sync_totals_hists(self):
        t, h = self.out_a["totals"], self.out_a["hists"]
        both = torch.cat([t.to(torch.int64), h.reshape(-1).to(torch.int64)]).cpu().numpy()
        return both[: t.shape[0]], both[t.shape[0]:].reshape(h.shape)

    def pack(self):
        """Read program A's totals and histograms (re-running A at a larger
        token cap when a group overflowed), build the entropy codes, run
        program B. Idempotent. One-pass tier: the combined program already
        ran; only the token-capacity check remains."""
        if self._packed:
            return
        self._packed = True
        if self._static:
            g2 = 2 * (self.dim.num_groups + self.dim.num_dc_groups)
            totals = self._small_sync()[g2:-2]
            if int(totals.max(initial=0)) > self.cap:
                self.cap = _next_bucket(_CAP_BUCKETS, int(totals.max()))
                self._dispatch_b()
            return
        totals, hists = self._sync_totals_hists()
        if int(totals.max(initial=0)) > self.cap:
            self.cap = _next_bucket(_CAP_BUCKETS, int(totals.max()))
            self.out_a = self._run_a(self.cap)
            totals, hists = self._sync_totals_hists()
        self.full_code, d_table = build_ac_device_code(hists[0], ac_base64_map())
        self.dc_code, d_table_dc = build_dc_device_code(hists[1][: C.NUM_DC_CONTEXTS])
        self._stream = self.out_a["stream"][:, : self.cap].contiguous()
        self._d_ac = torch.from_numpy(d_table).to(self.device)
        self._d_dc = torch.from_numpy(d_table_dc).to(self.device)
        self._dispatch_b()

    def _dispatch_b(self):
        g, gd = self.dim.num_groups, self.dim.num_dc_groups
        self.wcap = min(1 << int(g * self.ow).bit_length(), 2 * 1024 * 1024)
        self._wcap_dc = min(1 << int(gd * self._ow_dc).bit_length(), 2 * 1024 * 1024)
        sizes = dict(
            ow_ac=self.ow, wcap_ac=self.wcap, ow_dc=self._ow_dc,
            wcap_dc=self._wcap_dc, compact_ac=self._compact_ac,
            compact_dc=self._compact_dc, kernels=self.kernels,
        )
        if self._static:
            self.out_b = analyze_pack_static(
                self._up, self._yb, self._xb, self._d_ac, self._d_dc,
                self._ac_depths, self._dc_depths, self.distp, self.cap,
                self.tables, cfl=self.config.optimize_chroma_from_luma,
                blocks=self.config.optimize_block_sizes, **sizes,
            )
        else:
            self.out_b = pack_all_sections(
                self._stream, self.out_a["totals"], self._d_ac,
                self.out_a["dc_layout"], self._d_dc, **sizes,
            )
        self._small_np = None
        self._ac_list = None

    def _small_sync(self):
        """One device->host copy of [ac_bits, ac_offs, dc_bits, dc_offs]
        (one-pass tier: followed by [totals, k_ac, k_dc])."""
        if self._small_np is None:
            self._small_np = self.out_b["small"].cpu().numpy()
        return self._small_np

    @staticmethod
    def _used_words(bits, offs):
        """Words the compacted buffer actually needs for these sections."""
        nblk = (bits + (32 * 128 - 1)) // (32 * 128)
        return int(offs[-1] + nblk[-1] * 128) if len(offs) else 0

    def _dl_words(self, bits, offs, wcap):
        """Download word count (65536-quantized) for a compacted buffer."""
        used = self._used_words(bits, offs)
        assert used <= wcap, "caller must fall back to the uncompacted rows"
        return min(wcap, -(-max(used, 1) // 65536) * 65536)

    @staticmethod
    def _writers(words, bits, offs):
        return [
            _writer_from_bits(
                words[offs[k]: offs[k] + (bits[k] + 31) // 32].view(np.uint8),
                int(bits[k]),
            )
            for k in range(len(bits))
        ]

    @staticmethod
    def _writers_rows(words_dev, bits):
        """Per-section writers from uncompacted [n, ow] rows."""
        maxw = (int(bits.max(initial=0)) + 31) // 32
        words = words_dev[:, : max(maxw, 1)].cpu().numpy()
        return [
            _writer_from_bits(
                np.ascontiguousarray(words[k, : (int(bits[k]) + 31) // 32]).view(np.uint8),
                int(bits[k]),
            )
            for k in range(len(bits))
        ]

    def _fetch_sections(self):
        if self._ac_list is not None:
            return
        g, gd = self.dim.num_groups, self.dim.num_dc_groups
        margin = VAR_FAN + 1
        while True:
            small = self._small_sync()
            ac_bits, ac_offs = small[:g], small[g: 2 * g]
            dc_bits, dc_offs = small[2 * g: 2 * g + gd], small[2 * g + gd: 2 * g + 2 * gd]
            need_ac = (int(ac_bits.max(initial=0)) + 31) // 32
            if need_ac > var_safe_words(self.ow):
                self.ow = _next_bucket(_OW_BUCKETS, need_ac + margin)
                self._dispatch_b()
                continue
            need_dc = (int(dc_bits.max(initial=0)) + 31) // 32
            if need_dc > var_safe_words(self._ow_dc):
                self._ow_dc = _next_bucket(_OW_BUCKETS, need_dc + margin)
                self._dispatch_b()
                continue
            if self._compact_ac and self._used_words(ac_bits, ac_offs) > self.wcap:
                self._compact_ac = False
                self._dispatch_b()
                continue
            if self._compact_dc and self._used_words(dc_bits, dc_offs) > self._wcap_dc:
                self._compact_dc = False
                self._dispatch_b()
                continue
            break
        ac_words, dc_words = self.out_b["ac_words"], self.out_b["dc_words"]
        if self._compact_ac and self._compact_dc:
            # Both compacted buffers in one device->host copy.
            dl_ac = self._dl_words(ac_bits, ac_offs, self.wcap)
            dl_dc = self._dl_words(dc_bits, dc_offs, self._wcap_dc)
            both = torch.cat([ac_words[:dl_ac], dc_words[:dl_dc]]).cpu().numpy()
            self._ac_list = self._writers(both[:dl_ac], ac_bits, ac_offs)
            self._dc_list = self._writers(both[dl_ac:], dc_bits, dc_offs)
            return
        if self._compact_ac:
            dl = self._dl_words(ac_bits, ac_offs, self.wcap)
            self._ac_list = self._writers(ac_words[:dl].cpu().numpy(), ac_bits, ac_offs)
        else:
            self._ac_list = self._writers_rows(ac_words, ac_bits)
        if self._compact_dc:
            dl = self._dl_words(dc_bits, dc_offs, self._wcap_dc)
            self._dc_list = self._writers(dc_words[:dl].cpu().numpy(), dc_bits, dc_offs)
        else:
            self._dc_list = self._writers_rows(dc_words, dc_bits)

    def _ac_writers(self):
        self._fetch_sections()
        return self._ac_list

    def _dc_writers(self):
        self._fetch_sections()
        return self._dc_list

    def result(self) -> bytes:
        self.pack()
        if self._static:
            # ACGlobal / DCGlobal must serialize the candidate tables the
            # device packed with; the picks are the same in every
            # re-dispatch (same histograms).
            small = self._small_sync()
            self.full_code = self._static_codes.ac_codes[int(small[-2])]
            self.dc_code = self._static_codes.dc_codes[int(small[-1])]
        return assemble_codestream(
            self.dim, self.distp, self._ac_writers, self.full_code,
            self._dc_writers, self.dc_code,
        )


def encode_image_device(img: np.ndarray, distance: float = 1.0,
                        upload_dtype=np.float16, cap: int = 32768,
                        ow: int = 8192, config=None, device=None,
                        kernels=True) -> bytes:
    """Encode a [3, H, W] image on the card: float (linear sRGB, uploaded as
    upload_dtype) or uint8 (sRGB samples, linearized on the device).

    device=None runs on the CUDA card and raises without one; pass
    device="cpu" to run the plain torch versions on the CPU."""
    job = DeviceEncodeJob(img, distance, upload_dtype, cap, ow, config=config,
                          device=device, kernels=kernels)
    job.pack()
    return job.result()
