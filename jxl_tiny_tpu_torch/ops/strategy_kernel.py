"""AC-strategy entropy estimates ("kernel E"): CUDA kernel
(csrc/strategy.cu) and its plain torch version.

Counterpart of the JAX package's ops/strategy_kernel.py (`_estimate_kernel`,
reached through `estimate_partials`). Every aligned 16x16 quad is scored as
4 x DCT8 against 2 x DCT16X8 against 2 x DCT8X16 by estimating the token
entropy of each candidate cell (enc_ac_strategy.cc:51-146, 167-238). The
kernel computes, for each group, channel and family (8x8 cells of 64
coefficients, 16x8 and 8x16 cells of 128), two per-cell partial sums over
the cell's coefficients; the cheap combine over channels and the quad
decisions stay in torch on the small cell maps (`combine_partials`,
ops/pipeline.compute_ac_strategy).

Every float sum over a cell's coefficients is the halving tree
`x[..., :n/2] + x[..., n/2:]`, repeated down to one value: the order a warp
gets from strided loads and a shuffle-down reduction. The plain version
spells the same tree out and never calls torch.sum, so the kernel equals it
bit for bit on the card. Only + - * rint abs and the correctly rounded sqrt
touch the floats (sqrt in the plain version goes through float64 and rounds
once, which is the correctly rounded float32 sqrt on every device).
"""
import ctypes

import numpy as np
import torch

from ._build import I, P, check, load, require, stream_ptr

F32 = np.float32

# enc_ac_strategy.cc:51-146 cost constants.
K_ABOVE15 = F32(4.4628149885273363)
K_SQRT = F32(5.3359184934516337)
K_NZ_SLOPE = F32(8.8703248061477744)
K_NBITS = F32(7.565053364251793)
K_IL = F32(138.0)
K_IL2 = F32(50.46839691767866)


def nz_cost(slope):
    """float32 cost of one nonzero coefficient at this entropy slope."""
    return F32(1.0 + slope * float(K_NZ_SLOPE))


def _ceil_log2_nz(v):
    """Exact integer ceil(log2(max(v, 1))) of an integer tensor, from the
    float32 exponent bits (exact for v < 2^24); never log2, whose last-ulp
    error can flip the ceil at exact powers of two. Returns int32."""
    vi = torch.clamp_min(v, 1).to(torch.int32)
    n = (vi.to(torch.float32).view(torch.int32) >> 23) - 127
    return n + (vi != (1 << n)).to(torch.int32)


def tree_sum(x):
    """Sum over the last axis (a power of two) as a halving tree."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _sqrt32(x):
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _family_plain(coef, qm, q, m, fac, k_nz):
    """One family. coef: [G,3,R,C,S]; qm: [3,S]; q/m: [G,R,C]; fac:
    [G,2,R,C] (fac_x, fac_b). Returns [G,3,2,R,C] (ent, il2)."""
    cf = torch.stack([fac[:, 0], torch.zeros_like(fac[:, 0]), fac[:, 1]], dim=1)
    val = (coef - cf[..., None] * coef[:, 1:2]) * qm[None, :, None, None, :]
    val = val * q[:, None, :, :, None]
    rval = torch.round(val)
    diff = torch.abs(val - rval)
    aq = torch.abs(rval)
    nz = aq != 0
    zero = torch.zeros_like(aq)
    mk = (m * float(K_IL))[:, None, :, :, None]
    e = (
        torch.where(aq >= 1.5, zero + float(K_ABOVE15), zero)
        + _sqrt32(aq) * float(K_SQRT)
        + torch.where(nz, zero + float(k_nz), zero)
        + mk * diff
    )
    esum = tree_sum(e)
    il2 = tree_sum(diff * diff)
    nzeros = nz.sum(dim=-1, dtype=torch.int32)
    nbits = _ceil_log2_nz(nzeros + 1) + 1
    tail = float(K_NBITS) * (_ceil_log2_nz(nbits + 17) + nbits).to(torch.float32)
    return torch.stack([esum + tail, il2], dim=2)


def estimate_partials_plain(coef8, coef_v, coef_h, q8, qv, qh, m8, mv, mh,
                            fac8, facv, fach, qm8, qm16, slope):
    """Plain torch version of the kernel; arguments and outputs as
    `estimate_partials`."""
    k_nz = nz_cost(slope)
    return (
        _family_plain(coef8, qm8, q8, m8, fac8, k_nz),
        _family_plain(coef_v, qm16, qv, mv, facv, k_nz),
        _family_plain(coef_h, qm16, qh, mh, fach, k_nz),
    )


def _bind(lib):
    lib.strategy_launch.argtypes = [P] * 17 + [I, ctypes.c_float, P]
    lib.strategy_launch.restype = I


class _Estimate:
    """Kernel wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, coef8, coef_v, coef_h, q8, qv, qh, m8, mv, mh,
                 fac8, facv, fach, qm8, qm16, slope):
        """coef8: [G,3,32,32,64]; coef_v: [G,3,16,32,128]; coef_h:
        [G,3,32,16,128] f32; q8/qv/qh: [G,32,32] / [G,16,32] / [G,32,16]
        f32 quant maps; m8/mv/mh: the matching masking maps; fac8/facv/fach:
        [G,2,...] stacked (fac_x, fac_b) cell maps; qm8/qm16: [3,64] /
        [3,128] quant weights; slope: the entropy slope min(1, distance/3).

        Returns (p8 [G,3,2,32,32], pv [G,3,2,16,32], ph [G,3,2,32,16]) f32
        in raster cell order: axis 1 = channel, axis 2 = (entropy partial
        with masking*138*info_loss folded in, info_loss2 partial).

        CPU tensors take the plain version; CUDA tensors launch the kernel."""
        args = (coef8, coef_v, coef_h, q8, qv, qh, m8, mv, mh, fac8, facv,
                fach, qm8, qm16)
        if not coef8.is_cuda:
            return estimate_partials_plain(*args, slope)
        g = coef8.shape[0]
        f32 = torch.float32
        fams = ((32, 32, 64), (16, 32, 128), (32, 16, 128))
        for (r, c, s), coef, q, m, fac, name in zip(
            fams, (coef8, coef_v, coef_h), (q8, qv, qh), (m8, mv, mh),
            (fac8, facv, fach), ("8x8", "16x8", "8x16"),
        ):
            require(coef, f32, (g, 3, r, c, s), f"estimate_partials coef {name}")
            require(q, f32, (g, r, c), f"estimate_partials q {name}")
            require(m, f32, (g, r, c), f"estimate_partials m {name}")
            require(fac, f32, (g, 2, r, c), f"estimate_partials fac {name}")
        require(qm8, f32, (3, 64), "estimate_partials qm8")
        require(qm16, f32, (3, 128), "estimate_partials qm16")
        dev = coef8.device
        outs = tuple(
            torch.empty((g, 3, 2, r, c), dtype=f32, device=dev) for r, c, _ in fams
        )
        lib = load("strategy", _bind)
        check(
            lib.strategy_launch(
                *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
                g, float(nz_cost(slope)), stream_ptr(coef8),
            ),
            "estimate_partials",
        )
        self.launches += 1
        return outs


estimate_partials = _Estimate()


def combine_partials(p, masking, num_blocks):
    """Per-channel partials [G,3,2,...] + masking [G,...] -> estimate map
    [G,...]: channel sums in the fixed order (X + Y) + B, then the
    info_loss2 term (the 138*info_loss term already rides inside the
    entropy partial)."""
    entropy = (p[:, 0, 0] + p[:, 1, 0]) + p[:, 2, 0]
    il2 = (p[:, 0, 1] + p[:, 1, 1]) + p[:, 2, 1]
    return entropy + masking * (float(K_IL2) * _sqrt32(float(num_blocks) * il2))
