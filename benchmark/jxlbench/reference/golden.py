"""The golden model of one group, and the reference's own 8-bit sRGB.

analyze_group is a frozen copy of analyze_group_numpy, _extract_group and
_pad_tile_map of jxl_tiny_tpu_torch/encoder.py at commit 8ebce9c, returning
the decisions and quantized values instead of a GroupResult. The sRGB
transfer functions are IEC 61966-2-1's, written here in float64 and
rounded to float32 once: the port reads a table of its own for 8-bit input,
which the reference does not take.
"""
import numpy as np

from . import group_np as G
from . import pipeline_np as P
from .common import div_ceil


def linear_to_srgb_u8(img: np.ndarray) -> np.ndarray:
    """[3, H, W] linear sRGB -> sRGB-encoded u8 (IEC 61966-2-1 OETF,
    rounded to nearest); out-of-gamut values clip."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    srgb = np.where(x <= np.float32(0.0031308), x * np.float32(12.92),
                    np.float32(1.055) * np.power(x, np.float32(1.0 / 2.4)) - np.float32(0.055))
    return np.clip(srgb * np.float32(255.0) + np.float32(0.5), 0, 255).astype(np.uint8)


def srgb_u8_to_linear_table() -> np.ndarray:
    """[256] float32: the linear value of each 8-bit sRGB sample (the
    IEC 61966-2-1 EOTF in float64, rounded to float32)."""
    x = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


def extract_group(img, gx, gy):
    """Edge-replicated 256x256 patch (CopyAndPadImage, enc_frame.cc:597-617)."""
    _, h, w = img.shape
    ys = np.clip(gy * 256 + np.arange(256), 0, h - 1)
    xs = np.clip(gx * 256 + np.arange(256), 0, w - 1)
    return img[:, ys[:, None], xs[None, :]]


def _pad_tile_map(m):
    ty, tx = m.shape
    return np.pad(m, ((0, 4 - ty), (0, 4 - tx)), mode="edge")


def analyze_group(patch, yb, xb, distp, round_fn=None) -> dict:
    """One group's [3, 256, 256] float32 linear patch (edge-replicated past
    the image) with yb x xb valid blocks -> the golden model's decisions:
    strategy, is_first, raw_qf [yb, xb]; ytox, ytob [ty, tx]; quant_dc
    [3, yb, xb]; quantized [3, yb, xb, 128]; tokens (the AC tokens the
    group emits). round_fn, for the control: applied to the pixels and to
    the XYB planes, the data every later stage reads."""
    if round_fn is not None:
        patch = round_fn(patch)
    xyb = P.to_xyb(patch)
    if round_fn is not None:
        xyb = round_fn(xyb)
    qf, masking, raw_qf = P.compute_adaptive_quant_field(xyb, distp.distance, distp.inv_scale)
    ytox, ytob = P.compute_cmap(xyb, xb, yb)
    ytox_p, ytob_p = _pad_tile_map(ytox), _pad_tile_map(ytob)
    strategy, is_first = P.compute_ac_strategy(xyb, qf, masking, ytox_p, ytob_p,
                                               distp.distance, xb, yb)
    raw_qf = P.adjust_quant_field(strategy, is_first, raw_qf)
    gt = G.encode_group(xyb, strategy, is_first, raw_qf, ytox_p, ytob_p, distp.scale,
                        distp.scale_dc, distp.x_qm_mul, xb, yb)
    ty, tx = div_ceil(yb, 8), div_ceil(xb, 8)
    return dict(strategy=strategy[:yb, :xb], is_first=is_first[:yb, :xb],
                raw_qf=raw_qf[:yb, :xb], ytox=ytox[:ty, :tx], ytob=ytob[:ty, :tx],
                quant_dc=gt.quant_dc[:, :yb, :xb], quantized=gt.quantized[:, :yb, :xb],
                tie_ac=gt.ties["ac"][:, :yb, :xb], tie_dc=gt.ties["dc"][:, :yb, :xb],
                tokens=int(gt.counts[:yb, :xb].sum()))
