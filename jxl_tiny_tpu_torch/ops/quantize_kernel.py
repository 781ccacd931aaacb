"""Fused quantize ("kernel F"): CUDA kernel (csrc/quantize.cu) and its plain
torch version.

Counterpart of the JAX package's ops/quantize_kernel.py (`_quant_kernel`,
reached through `quantize_cells`). Per cell: strategy-selected coefficients
and tables, Y quantize + dequant roundtrip bias, CfL-unapply of X and B,
X/B quantize, the DC pairs (DC-CfL for B), the zig-zag reorder, nonzero
counts and the last nonzero scan position. All three strategies (DCT8,
DCT16X8, DCT8X16) are handled. Only IEEE * / and round-half-even touch the
floats, so the plain version matches the kernel exactly on the card.
"""
import ctypes

import numpy as np
import torch

from .. import constants as C
from ._build import I, P, check, load, require, stream_ptr

F32 = np.float32


def quant_scalars(scale, scale_dc, x_qm_mul):
    """float32 scalars of one quantization setting (same float32
    expressions as the JAX kernel)."""
    inv_factor = C.INV_DC_QUANT * F32(scale_dc)
    return dict(
        scale=F32(scale),
        x_qm_mul=F32(x_qm_mul),
        inv_factor=inv_factor.astype(np.float32),
        cfl_b=F32(C.INV_DC_QUANT[2] * C.DC_QUANT[1]),
        bias=C.DEFAULT_QUANT_BIAS.astype(np.float32),
        sc=F32(C.DCT_SCALE_16_TO_2),
    )


def round_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def quantize_cells_plain(coef8, coef_v, coef_h, strategy, raw_qf, fac_x, fac_b,
                         tables, scale, scale_dc, x_qm_mul):
    """Plain torch version; shapes and outputs as `quantize_cells`."""
    k = quant_scalars(scale, scale_dc, x_qm_mul)
    s = strategy.long()  # [G,32,32]
    quant = raw_qf.to(torch.float32)
    qac = quant * float(k["scale"])
    inv_qac = 1.0 / (quant * float(k["scale"]))
    c2 = s != C.DCT8
    sl = s[:, None, :, :, None]  # [G,1,32,32,1]
    a8 = torch.cat([coef8, torch.zeros_like(coef8)], dim=-1)
    cv = coef_v.repeat_interleave(2, dim=2)  # [G,3,32,32,128]
    chh = coef_h.repeat_interleave(2, dim=3)
    coefs = torch.where(sl == C.DCT8, a8, torch.where(sl == C.DCT16X8, cv, chh))

    def tab(t, ch):  # [3,3,128] table -> per-cell [G,32,32,128]
        return t[s, ch]

    def quantize(coef, ch, mul):
        val = coef * tab(tables.qm_tab, ch) * (qac * float(mul))[..., None]
        q = torch.where(
            torch.abs(val) >= tab(tables.thr_tab, ch), torch.round(val),
            torch.zeros_like(val),
        )
        return torch.clamp(q, -float(C.AC_COEF_CLAMP), float(C.AC_COEF_CLAMP)).to(
            torch.int32
        )

    bias = k["bias"]
    cy = coefs[:, 1]
    qy = quantize(cy, 1, 1.0)
    qyf = qy.to(torch.float32)
    small = torch.abs(qyf) < 1.125
    zero = torch.zeros_like(qyf)
    one = torch.where(
        qy == 0, zero,
        torch.where(qyf < 0, zero - float(bias[1]), zero + float(bias[1])),
    )
    # b3 / q as a tensor division: torch turns `scalar / tensor` into a
    # reciprocal times the scalar, which rounds twice.
    big = qyf - torch.full_like(qyf, float(bias[3])) / torch.where(
        qy == 0, torch.ones_like(qyf), qyf
    )
    y_deq = torch.where(small, one, big) * tab(tables.dqm_tab, 1) * inv_qac[..., None]
    cx = coefs[:, 0] - fac_x[..., None] * y_deq
    cb = coefs[:, 2] - fac_b[..., None] * y_deq
    qx = quantize(cx, 0, k["x_qm_mul"])
    qb = quantize(cb, 2, 1.0)

    def dc_pair(coef):  # [G,32,32,128] -> [G,2,32,32]
        c0 = coef[..., 0]
        c1 = coef[..., 1] * float(k["sc"])
        return torch.stack([torch.where(c2, c0 + c1, c0), c0 - c1], dim=1)

    dclamp = float(C.DC_VALUE_CLAMP)

    def dc_clip(v):
        return torch.clamp(v, -dclamp, dclamp).to(torch.int32)

    inv_f = k["inv_factor"]
    qdc_y = dc_clip(round_away(dc_pair(cy) * float(inv_f[1])))
    qdc_x = dc_clip(round_away(dc_pair(cx) * float(inv_f[0])))
    qdc_b = dc_clip(
        round_away(
            dc_pair(cb) * float(inv_f[2]) - qdc_y.to(torch.float32) * float(k["cfl_b"])
        )
    )
    qdc = torch.stack([qdc_x, qdc_y, qdc_b], dim=1)  # [G,3,2,32,32]

    perm = tables.order_tab.long()[s]  # [G,32,32,128]: ordered[j] = q[perm[j]]
    lanes = torch.arange(128, device=coef8.device)
    covered = torch.where(c2, 2, 1)[..., None]
    in_range = (lanes >= covered) & (lanes < covered * 64)
    ordered, nzs, lasts = [], [], []
    for q in (qx, qy, qb):
        od = torch.gather(q, -1, perm)
        nzm = (od != 0) & in_range
        nzs.append(nzm.sum(dim=-1, dtype=torch.int32))
        lasts.append(torch.where(nzm, lanes, 0).amax(dim=-1).to(torch.int32))
        ordered.append(od)
    # Emission layout [G,32,32,3,128], channel order Y, X, B.
    ordered_em = torch.stack([ordered[1], ordered[0], ordered[2]], dim=3)
    return (
        ordered_em.contiguous(),
        torch.stack(nzs, dim=1),
        qdc,
        torch.stack(lasts, dim=1),
    )


class _Params(ctypes.Structure):
    """csrc/quantize.cu:Params."""

    _fields_ = [("scalars", ctypes.c_float * 11), ("dc_pos", ctypes.c_int * 6)]


def _bind(lib):
    lib.quantize_launch.argtypes = [P] * 15 + [I, P, P]
    lib.quantize_launch.restype = I


class _Quantize:
    """Kernel wrapper; `launches` counts kernel launches. The scalar block
    of a quantization setting is made once, on the host (it goes to the
    kernel as a parameter), and the tables in zig-zag order are buffers of
    `tables`, so a call copies nothing to the card."""

    def __init__(self):
        self.launches = 0
        self._params = {}

    def params_for(self, scale, scale_dc, x_qm_mul, dc_pos):
        key = (float(scale), float(scale_dc), float(x_qm_mul), dc_pos)
        if key not in self._params:
            k = quant_scalars(scale, scale_dc, x_qm_mul)
            self._params[key] = _Params(
                (ctypes.c_float * 11)(
                    k["scale"], k["x_qm_mul"], *k["inv_factor"], k["cfl_b"],
                    *k["bias"], k["sc"],
                ),
                (ctypes.c_int * 6)(*(p for pair in dc_pos for p in pair)),
            )
        return self._params[key]

    def __call__(self, coef8, coef_v, coef_h, strategy, raw_qf, fac_x, fac_b,
                 tables, scale, scale_dc, x_qm_mul):
        """coef8: [G,3,32,32,64] f32; coef_v: [G,3,16,32,128]; coef_h:
        [G,3,32,16,128]; strategy/raw_qf: [G,32,32] i32; fac_x/fac_b:
        [G,32,32] f32.

        Returns (ordered_em [G,32,32,3,128] i32 zig-zag quantized values in
        emission layout, channels Y,X,B; nzeros [G,3,32,32] i32; qdc
        [G,3,2,32,32] i32 DC pairs; lastnz [G,3,32,32] i32), channel order
        X,Y,B for the last three."""
        if not coef8.is_cuda:
            return quantize_cells_plain(
                coef8, coef_v, coef_h, strategy, raw_qf, fac_x, fac_b, tables,
                scale, scale_dc, x_qm_mul,
            )
        g = coef8.shape[0]
        dev = coef8.device
        require(coef8, torch.float32, (g, 3, 32, 32, 64), "quantize coef8")
        require(coef_v, torch.float32, (g, 3, 16, 32, 128), "quantize coef_v")
        require(coef_h, torch.float32, (g, 3, 32, 16, 128), "quantize coef_h")
        require(strategy, torch.int32, (g, 32, 32), "quantize strategy")
        require(raw_qf, torch.int32, (g, 32, 32), "quantize raw_qf")
        require(fac_x, torch.float32, (g, 32, 32), "quantize fac_x")
        require(fac_b, torch.float32, (g, 32, 32), "quantize fac_b")
        for name in ("qm_zz", "thr_zz", "dqm_zz", "order_zz"):
            if getattr(tables, name).device != dev:
                raise ValueError(f"quantize tables.{name}: expected a tensor on {dev}")
        params = self.params_for(scale, scale_dc, x_qm_mul, tables.dc_pos)
        ordered = torch.empty((g, 32, 32, 3, 128), dtype=torch.int32, device=dev)
        nz = torch.empty((g, 3, 32, 32), dtype=torch.int32, device=dev)
        qdc = torch.empty((g, 3, 2, 32, 32), dtype=torch.int32, device=dev)
        lastnz = torch.empty((g, 3, 32, 32), dtype=torch.int32, device=dev)
        lib = load("quantize", _bind)
        check(
            lib.quantize_launch(
                coef8.data_ptr(), coef_v.data_ptr(), coef_h.data_ptr(),
                strategy.data_ptr(), raw_qf.data_ptr(), fac_x.data_ptr(),
                fac_b.data_ptr(), tables.qm_zz.data_ptr(),
                tables.thr_zz.data_ptr(), tables.dqm_zz.data_ptr(),
                tables.order_zz.data_ptr(), ordered.data_ptr(),
                nz.data_ptr(), qdc.data_ptr(), lastnz.data_ptr(), g,
                ctypes.addressof(params), stream_ptr(coef8),
            ),
            "quantize_cells",
        )
        self.launches += 1
        return ordered, nz, qdc, lastnz


quantize_cells = _Quantize()
