"""Shared helpers: geometry, distance-derived quantization parameters.

Reference behavior: encoder/enc_frame.cc:95-156 (ComputeDistanceParams).

Frozen copy for the benchmark of jxl_tiny_tpu_torch/common.py at commit
8ebce9c.
"""
import dataclasses

import numpy as np


def div_ceil(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ImageDim:
    """Derived per-image geometry (reference: enc_frame.cc:48-93)."""

    xsize: int
    ysize: int

    @property
    def xsize_blocks(self):
        return div_ceil(self.xsize, 8)

    @property
    def ysize_blocks(self):
        return div_ceil(self.ysize, 8)

    @property
    def xsize_groups(self):
        return div_ceil(self.xsize, 256)

    @property
    def ysize_groups(self):
        return div_ceil(self.ysize, 256)

    @property
    def xsize_dc_groups(self):
        return div_ceil(self.xsize, 2048)

    @property
    def ysize_dc_groups(self):
        return div_ceil(self.ysize, 2048)

    @property
    def num_groups(self):
        return self.xsize_groups * self.ysize_groups

    @property
    def num_dc_groups(self):
        return self.xsize_dc_groups * self.ysize_dc_groups


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Capability tiers, mirroring the reference's compile-time toggles
    (encoder/config.h:10-12). Here they are runtime options.

    optimize_code: two-pass clustered entropy codes (enc_frame.cc:765-802)
        vs one-pass static codes (static_entropy_codes.h role; our tables are
        corpus-trained, constants/static_codes.npz).
    optimize_chroma_from_luma: least-squares CfL factors per 64x64 tile
        (enc_chroma_from_luma.cc) vs ytox=ytob=0.
    optimize_block_sizes: 16x8/8x16 DCT selection (enc_ac_strategy.cc) vs
        all-DCT8.
    """

    optimize_code: bool = True
    optimize_chroma_from_luma: bool = True
    optimize_block_sizes: bool = True


DEFAULT_CONFIG = EncoderConfig()


def quant_dc(distance: float) -> float:
    """enc_frame.cc:95-102."""
    k_dc_quant_pow = 0.57
    k_dc_quant = 1.12
    k_dc_mul = 2.9
    eff = k_dc_mul * (distance / k_dc_mul) ** k_dc_quant_pow
    eff = min(max(eff, 0.5 * distance), distance)
    return min(k_dc_quant / eff, 50.0)


@dataclasses.dataclass(frozen=True)
class DistanceParams:
    distance: float
    global_scale: int
    quant_dc: int
    scale: float
    inv_scale: float
    scale_dc: float
    x_qm_scale: int
    epf_iters: int

    @property
    def x_qm_mul(self) -> float:
        # enc_group.cc:338
        return float(np.float32(1.25) ** np.float32(self.x_qm_scale - 2.0))


def compute_distance_params(distance: float) -> DistanceParams:
    """enc_frame.cc:115-156."""
    k_global_scale_denom = 1 << 16
    k_global_scale_numerator = 4096
    k_ac_quant = 0.8
    k_quant_field_target = 5.0
    qdc = quant_dc(distance)
    scale = k_global_scale_denom * k_ac_quant / (distance * k_quant_field_target)
    scale = min(max(scale, 1.0), float(1 << 15))
    scaled_quant_dc = int(qdc * k_global_scale_numerator * 1.6)
    global_scale = min(max(int(scale), 1), scaled_quant_dc)
    scale = global_scale * (1.0 / k_global_scale_denom)
    inv_scale = 1.0 / scale
    qdc_i = int(qdc / scale + 0.5)
    qdc_i = min(max(qdc_i, 1), 1 << 16)
    scale_dc = qdc_i * scale
    x_qm_scale = 2
    for step in (1.25, 9.0):
        if distance > step:
            x_qm_scale += 1
    if distance < 0.299:
        x_qm_scale += 1
    epf_iters = sum(1 for t in (0.7, 1.5, 4.0) if distance >= t)
    return DistanceParams(
        distance=distance,
        global_scale=global_scale,
        quant_dc=qdc_i,
        scale=scale,
        inv_scale=inv_scale,
        scale_dc=scale_dc,
        x_qm_scale=x_qm_scale,
        epf_iters=epf_iters,
    )


def clamp_distance(distance: float) -> float:
    """enc_file.cc:57-65."""
    from .errors import InvalidInputError

    if distance < 0.0:
        raise InvalidInputError(f"invalid distance {distance}")
    if distance == 0.0:
        raise InvalidInputError("lossless is not supported")
    return max(distance, 0.03)
