"""Adaptive-quant field: CUDA kernel (csrc/aq.cu) and its plain torch version.

Counterpart of the JAX package's ops/aq_kernel.py (`_aq_kernel`, reached
through `adaptive_quant_field_kernel`). Per 256x256 group: the gamma ratio
of derivatives, the 4-neighbour difference with the masking sqrt, a 4x4
fold to [64, 64], the 3x3 fuzzy erosion (sum of the 4 smallest of 9), a 2x2
fold to [32, 32], and the HF and colour modulations. The kernel emits
(val, gamma block sums, masking); the log2/exp2 tail runs in torch on the
tiny [G, 32, 32] maps (`adaptive_quant_field`), as in the JAX package, so
that only + - * / sqrt min max abs run inside the kernel and the kernel
equals its plain version bit for bit on the card.

Every sum uses the pinned left-fold order of ref/pipeline_np.strided_sum
(lanes first, then rows); the plain version spells it out with strided
slices and never calls torch.sum.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ._build import I, P, check, load, require, stream_ptr
from ..ref.pipeline_np import strided_sum

F32 = np.float32

# Index order of the constants vector; csrc/aq.cu reads the same indices.
_CONST_NAMES = (
    "rod_eps", "rod_num_mul", "rod_v_offset", "rod_den_mul", "gamma_off",
    "diff_x_w", "msq_mul", "msq_add", "mask_mul", "mask_min", "mask_a2",
    "mask_a3", "mask_a4", "mask_c0", "mask_c4", "mask_c2", "mask_c3",
    "masking_add", "hf_mul", "red_off", "red_max", "blue_off", "blue_max",
    "red_cap", "blue_cap", "color_c1", "color_c2", "color_c3", "gamma_y_off",
)


def aq_constants(distance):
    """(float32 constants vector, colour-modulation flag) for one distance.

    Each value is the same float32 expression as in the JAX package's
    pipeline_jax/aq_kernel, so both packages round their constants alike."""
    k_log2 = 0.693147181
    k_sg_mul = 226.0480446705883
    k_sg_ret_mul = (1.0 / 73.377132366608819) * 18.6580932135 * k_log2
    strength = np.float32(2.177823400325309) * np.float32(1.0 - 0.25 * distance)
    ratio = np.float32(30.610615782142737)
    k = dict(
        rod_eps=F32(1e-2),
        rod_num_mul=F32(k_sg_ret_mul * 3 * k_sg_mul),
        rod_v_offset=F32(7.14672470003 * k_log2 + 1e-2),
        rod_den_mul=F32(k_log2 * k_sg_mul),
        gamma_off=F32(0.019),
        diff_x_w=F32(23.426802998210313),
        msq_mul=np.float32(np.sqrt(211.50759899638012e8)),
        msq_add=F32(26.481471032459346),
        mask_mul=F32(0.74760422233706747),
        mask_min=F32(1e-3),
        mask_a2=F32(305.04035728311436),
        mask_a3=F32(2.1925739705298404),
        mask_a4=F32(0.25 * 2.1925739705298404),
        mask_c0=F32(-0.74174993),
        mask_c4=F32(3.2353257320940401),
        mask_c2=F32(12.906028311180409),
        mask_c3=F32(5.0220313103171232),
        masking_add=F32(0.001),
        hf_mul=F32(-2.0052193233688884 / 112),
        red_off=F32(0.0073200141118951231),
        red_max=F32(0.019421555948474039),
        blue_off=F32(0.26973418507870539),
        blue_max=F32(0.086890611400405895),
        red_cap=F32(ratio * 0.019421555948474039),
        blue_cap=F32(ratio * 0.086890611400405895),
        color_c1=F32(strength * -0.009174542291185913),
        color_c2=F32(strength * 5.992297772961519 / ratio),
        color_c3=F32(strength / ratio),
        gamma_y_off=F32(0.16),
    )
    vec = np.array([k[n] for n in _CONST_NAMES], np.float32)
    return vec, bool(strength >= 0)


def _k(vec):
    return {n: float(v) for n, v in zip(_CONST_NAMES, vec)}


def _ratio_of_derivatives(v, invert, k):
    v = torch.clamp_min(v, 0.0)
    v2 = v * v
    num = k["rod_num_mul"] * v2 + k["rod_eps"]
    den = k["rod_den_mul"] * v * v2 + k["rod_v_offset"]
    return num / den if invert else den / num


def _compute_mask(v, k):
    v1 = torch.clamp_min(v * k["mask_mul"], k["mask_min"])
    v2 = 1.0 / (v1 + k["mask_a2"])
    v3 = 1.0 / (v1 * v1 + k["mask_a3"])
    v4 = 1.0 / (v1 * v1 + k["mask_a4"])
    return k["mask_c0"] + k["mask_c4"] * v4 + k["mask_c2"] * v2 + k["mask_c3"] * v3


def _block_sums(a):  # [G, 256, 256] -> [G, 32, 32]: lanes, then rows
    return strided_sum(strided_sum(a, 8, 2), 8, 1)


def _pad_edge(p):  # [G, H, W] -> [G, H+2, W+2], edge replicated
    return F.pad(p[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]


def aq_field_plain(xyb, consts, color):
    """Plain torch version of the kernel: [G,3,256,256] f32 XYB ->
    (val, gamma block sums, masking), each [G,32,32] f32."""
    k = _k(consts)
    x_pl, y_pl, b_pl = xyb[:, 0], xyb[:, 1], xyb[:, 2]
    gammac = _ratio_of_derivatives(y_pl + k["gamma_off"], False, k)

    def diffsq(p):
        pp = _pad_edge(p)
        base = 0.25 * (
            pp[:, 2:, 1:-1] + pp[:, :-2, 1:-1] + pp[:, 1:-1, :-2] + pp[:, 1:-1, 2:]
        )
        d = gammac * (p - base)
        return d * d

    v = diffsq(y_pl) + k["diff_x_w"] * diffsq(x_pl)
    # sqrt through float64, rounded once: the correctly rounded float32
    # sqrt on every device (torch's float32 CPU sqrt is not always).
    diff = 0.25 * torch.sqrt((v * k["msq_mul"] + k["msq_add"]).double()).float()
    pre_erosion = strided_sum(strided_sum(diff, 4, 2), 4, 1) * 0.25  # [G,64,64]

    pe_pad = _pad_edge(pre_erosion)
    neigh = torch.stack(
        [
            pe_pad[:, 1 + dy : 65 + dy, 1 + dx : 65 + dx]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ]
    )
    neigh = torch.sort(neigh, dim=0).values
    low4 = (neigh[0] + neigh[1]) + (neigh[2] + neigh[3])
    ve = 0.05 * (pre_erosion + low4)
    aq = strided_sum(strided_sum(ve, 2, 2), 2, 1)  # [G,32,32]
    masking = 1.0 / (aq + k["masking_add"])

    val = _compute_mask(aq, k)
    # HfModulation: right/down absolute differences, zero on the last
    # column/row of each 8x8 block.
    yp = _pad_edge(y_pl)
    last8 = (torch.arange(256, device=xyb.device) % 8) == 7
    right = torch.abs(y_pl - yp[:, 1:-1, 2:])
    right = torch.where(last8[None, None, :], torch.zeros_like(right), right)
    down = torch.abs(y_pl - yp[:, 2:, 1:-1])
    down = torch.where(last8[None, :, None], torch.zeros_like(down), down)
    val = val + _block_sums(right + down) * k["hf_mul"]
    # ColorModulation.
    if color:
        red_slope = torch.clamp_max(
            torch.clamp_min(x_pl - k["red_off"], 0.0), k["red_max"]
        )
        blue_slope = torch.clamp_max(
            torch.clamp_min(b_pl - (y_pl + k["blue_off"]), 0.0), k["blue_max"]
        )
        red_cov = torch.clamp_max(_block_sums(red_slope), k["red_cap"])
        blue_cov = torch.clamp_max(_block_sums(blue_slope), k["blue_cap"])
        val = (
            val + k["color_c1"] + red_cov * k["color_c2"] + blue_cov * k["color_c3"]
        )
    # GammaModulation's block sums; its log2 runs in adaptive_quant_field.
    yo = y_pl + k["gamma_y_off"]
    ratio_avg = 0.5 * (
        _ratio_of_derivatives(yo - x_pl, True, k)
        + _ratio_of_derivatives(yo + x_pl, True, k)
    )
    return val, _block_sums(ratio_avg), masking


def _bind(lib):
    lib.aq_launch.argtypes = [P, P, P, P, P, I, I, P]
    lib.aq_launch.restype = I


class _AQ:
    """Kernel wrapper; `launches` counts kernel launches (CPU calls, which
    take the plain version, do not count)."""

    def __init__(self):
        self.launches = 0
        self._consts = {}

    def consts_for(self, distance):
        """(constants vector on the host, colour flag), made once a
        distance: the launcher hands them to the kernel as a parameter, so
        no call copies anything to the card."""
        key = float(distance)
        if key not in self._consts:
            self._consts[key] = aq_constants(distance)
        return self._consts[key]

    def __call__(self, xyb, distance):
        """[G,3,256,256] f32 -> (val, gamma block sums, masking) [G,32,32].

        CPU tensors take the plain version; CUDA tensors launch the kernel."""
        kvec, color = self.consts_for(distance)
        if not xyb.is_cuda:
            return aq_field_plain(xyb, kvec, color)
        g = xyb.shape[0]
        require(xyb, torch.float32, (g, 3, 256, 256), "aq_field xyb")
        val, gamma, mask = (
            torch.empty((g, 32, 32), dtype=torch.float32, device=xyb.device)
            for _ in range(3)
        )
        lib = load("aq", _bind)
        check(
            lib.aq_launch(
                xyb.data_ptr(), val.data_ptr(), gamma.data_ptr(),
                mask.data_ptr(), kvec.ctypes.data, g, int(color),
                stream_ptr(xyb),
            ),
            "aq_field",
        )
        self.launches += 1
        return val, gamma, mask


aq_field = _AQ()


def adaptive_quant_field(xyb, distance, inv_scale, kernels=True):
    """[G,3,256,256] -> (qf, masking, raw_qf) [G,32,32]: the kernel (or,
    with kernels=False, its plain version) plus the log2/exp2 tail."""
    if kernels:
        val, gamma_bs, masking = aq_field(xyb, distance)
    else:
        vec, color = aq_constants(distance)
        val, gamma_bs, masking = aq_field_plain(xyb, vec, color)
    scale = F32(0.8294 / distance)
    val = val + float(F32(-0.15526878023684174 * 0.693147180559945)) * torch.log2(
        gamma_bs * float(F32(1.0 / 64))
    )
    dampen = 1.0 if distance < 7.0 else max(0.0, 1.0 - (distance - 7.0) / 7.0)
    mul = float(F32(float(scale) * dampen))
    add = float(F32((1.0 - dampen) * 0.5 * float(scale)))
    qf = torch.exp2(val * float(F32(1.442695041))) * mul + add
    raw_qf = torch.clamp(
        (qf * float(F32(inv_scale)) + 0.5).to(torch.int32), 1, 255
    )
    return qf, masking, raw_qf
