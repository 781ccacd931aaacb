"""The exactness probe's kernels (csrc/probe.cu) and their plain torch
versions: one float op applied elementwise (`probe_elementwise`, the
counterpart of tools/probe_op_exactness.py:pallas_elementwise: the op a
template instantiation, float4 accesses where the pointers allow them) and an
int8 product with int32 sums (`probe_dot_i8`, the counterpart of its kern_i8:
mma.sync int8 tensor-core instructions, any shape).

No encode calls them; tools/probe_op_exactness.py and chip_smoke.py's phase
8 do, at the probe's shapes (2^19 floats, [256,128] x [128,128] int8) and at
photo8mp's (the [3,2160,3840] XYB planes; one permutation chunk of the JAX
quantizer's int8 zig-zag over the image, [414720,128] x [128,128]).
`probe_elementwise` can take the library built at another set of nvcc float
flags (FLAG_SETS) to show what the port's flags change.
"""
import torch

from . import _build
from ._build import I, P, check, load, require, stream_ptr

# op -> (code in csrc/probe.cu, number of float32 inputs)
OPS = {
    "exp2": (0, 1), "log2": (1, 1), "sqrt": (2, 1), "rsqrt": (3, 1), "div": (4, 2),
    "recip": (5, 1), "mul_add": (6, 3), "cbrt": (7, 1), "aq_tail": (8, 1),
    "exp": (9, 1), "log": (10, 1),
}
_ARCH_AND_LINK = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                  "-shared", "-Xcompiler", "-fPIC"]
# The builds the probe compares: the port's flags (every kernel of the
# encode); nvcc's own float defaults (FMA contraction on, IEEE division and
# square root); and contraction with the approximate division and square
# root (-use_fast_math without flushing subnormals).
FLAG_SETS = {
    "port": _build.NVCC_FLAGS,
    "nvcc-default": _ARCH_AND_LINK + ["-fmad=true", "-prec-div=true", "-prec-sqrt=true"],
    "approx": _ARCH_AND_LINK + ["-fmad=true", "-prec-div=false", "-prec-sqrt=false"],
}


def probe_elementwise_plain(op, a, b=None, c=None):
    """The op in torch on a's device, float32 (cbrt: pow(a, 1/3), as torch
    has no cube root)."""
    if op == "exp2":
        return torch.exp2(a)
    if op == "log2":
        return torch.log2(a)
    if op == "sqrt":
        return torch.sqrt(a)
    if op == "rsqrt":
        return torch.rsqrt(a)
    if op == "div":
        return a / b
    if op == "recip":
        return torch.reciprocal(a)
    if op == "mul_add":
        return a * b + c
    if op == "cbrt":
        return torch.pow(a, 1.0 / 3.0)
    if op == "aq_tail":
        return torch.exp2(a * 1.442695041) * 0.7 + 0.1
    if op == "exp":
        return torch.exp(a)
    if op == "log":
        return torch.log(a)
    raise ValueError(f"unknown probe op {op!r}")


def probe_dot_i8_plain(a, b):
    """[M, K] int8 x [K, N] int8 -> [M, N] int32, exact: int32 sums over K
    in order, 2^16 rows of A at a time (no [M, K, N] intermediate)."""
    rows = 1 << 16
    m, k = a.shape
    out = torch.zeros((m, b.shape[1]), dtype=torch.int32, device=a.device)
    b32 = b.to(torch.int32)
    for r in range(0, m, rows):
        a32 = a[r:r + rows].to(torch.int32)
        acc = out[r:r + rows]
        for t in range(k):
            acc.addcmul_(a32[:, t:t + 1], b32[t])
    return out


def _bind(lib):
    lib.probe_elementwise.argtypes = [P, P, P, P, I, I, P]
    lib.probe_elementwise.restype = I
    lib.probe_dot_i8.argtypes = [P, P, P, I, I, I, P]
    lib.probe_dot_i8.restype = I


class _Elementwise:
    """Kernel wrapper; `launches` counts kernel launches (CPU calls take
    the plain version and do not count)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, op, a, b=None, c=None, flags="port"):
        """op (a key of OPS) on contiguous float32 tensors of one shape
        (float4 accesses where every pointer is 16-byte aligned, scalar
        ones otherwise); flags: a key of FLAG_SETS, the build of
        csrc/probe.cu to launch."""
        code, n_in = OPS[op]
        ins = [a, b, c][:n_in]
        if not a.is_cuda:
            return probe_elementwise_plain(op, *ins)
        for k, t in enumerate(ins):
            require(t, torch.float32, a.shape, f"probe_elementwise input {k}")
        ins = ins + [a] * (3 - n_in)  # unused pointers
        out = torch.empty_like(a)
        lib = load("probe", _bind, FLAG_SETS[flags] if flags != "port" else None)
        check(lib.probe_elementwise(ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(),
                                    out.data_ptr(), a.numel(), code, stream_ptr(a)),
              f"probe_elementwise ({op}, {flags})")
        self.launches += 1
        return out


class _DotI8:
    """Kernel wrapper; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a, b):
        """[M, K] int8 x [K, N] int8 -> [M, N] int32 on the int8 tensor
        cores, exact; contiguous inputs of any M, K, N >= 1 (the kernel
        zero-pads the tails)."""
        if not a.is_cuda:
            return probe_dot_i8_plain(a, b)
        if a.dim() != 2 or b.dim() != 2 or min(*a.shape, b.shape[1]) < 1:
            raise ValueError(f"probe_dot_i8: expected [M, K] x [K, N] with M, K, N >= 1, got "
                             f"{tuple(a.shape)} x {tuple(b.shape)}")
        m, k = a.shape
        n = b.shape[1]
        require(a, torch.int8, (m, k), "probe_dot_i8 a")
        require(b, torch.int8, (k, n), "probe_dot_i8 b")
        out = torch.empty((m, n), dtype=torch.int32, device=a.device)
        lib = load("probe", _bind)
        check(lib.probe_dot_i8(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                               stream_ptr(a)), "probe_dot_i8")
        self.launches += 1
        return out


probe_elementwise = _Elementwise()
probe_dot_i8 = _DotI8()
