"""How do the float ops the encoder uses round, on each device the port runs
on? The counterpart of tools/probe_op_exactness.py (which compared XLA
against Pallas on the TPU).

The same inputs (RandomState(0): 2^18 points of linspace(1e-4, 64) and 2^18
log-uniform points in [1e-6, 1e4], the AQ value ranges, with y in [0.5, 2)
and z in [-1, 1)) go through exp2, log2, sqrt, rsqrt, div, recip, a*b+c,
cbrt, the AQ tail exp2(v*log2e)*m+a, exp and log. Every column is held
against one reference that any machine can compute: the op in float64 on
the float32 inputs, rounded once to float32. For each op and column the
probe reports the share of values that differ and the largest distance in
units in the last place (ulp). The columns:
  torch-cpu          torch's float32 op on the CPU
  port               the port's deterministic forms (float64 sqrt and pow,
                     rounded once, as ops/aq_kernel and ops/pipeline take
                     them): sqrt and cbrt only
  torch-cuda         torch's float32 op on the card
  kernel:<flags>     csrc/probe.cu probe_elementwise, built with the port's
                     flags (kernel:port), nvcc's float defaults
                     (kernel:nvcc-default) and contraction with approximate
                     division and square root (kernel:approx)
The XLA:CPU column is measured by tests/test_torch_probe.py, which may
import JAX; this module never does. On the card the probe also holds
probe_elementwise (port flags) against its plain version (torch on the
card) and probe_dot_i8 on the probe's int8 one-hot permutation against the
int32 product.

    python -m jxl_tiny_tpu_torch.tools.probe_op_exactness [--device cpu] [--log2-size 19]

prints one JSON line an op, then one for the int8 product.
"""
import argparse
import json

import numpy as np
import torch

from ..ops import probe_kernels as PK

LOG2E = np.float32(1.442695041)
# The ops whose probe_elementwise at the port's flags equals torch on the
# card bit for bit: every op but cbrt (cbrtf against torch's pow(x, 1/3)).
EQUAL_ON_CARD = tuple(op for op in PK.OPS if op != "cbrt")


def probe_inputs(log2_size=19):
    """(x, y, z) float32 [2^log2_size / 1024, 1024] and the int8 pair (q
    [256, 128], perm [128, 128] one-hot) of the probe, drawn from
    RandomState(0) in the order tools/probe_op_exactness.py draws them."""
    rng = np.random.RandomState(0)
    half = 1 << (log2_size - 1)
    x = np.concatenate([
        np.linspace(1e-4, 64.0, half).astype(np.float32),
        np.exp(rng.uniform(np.log(1e-6), np.log(1e4), half)).astype(np.float32),
    ])
    x = np.pad(x, (0, (-len(x)) % 1024)).reshape(-1, 1024)
    y = rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    z = rng.uniform(-1.0, 1.0, x.shape).astype(np.float32)
    rng.randn(256, 128)  # the float dot's operand, which the port does not probe
    q = rng.randint(0, 256, (256, 128)).astype(np.int8)
    perm = np.zeros((128, 128), np.int8)
    perm[np.arange(128), (np.arange(128) * 7) % 128] = 1
    return x, y, z, q, perm


def op_arguments(x, y, z):
    """{op: tuple of float32 arrays}: each op's arguments, as the probe
    forms them (in float32)."""
    e = x * np.float32(0.01) - np.float32(10.0)
    return {
        "exp2": (e,), "log2": (x,), "sqrt": (x,), "rsqrt": (x,), "div": (x, y),
        "recip": (x,), "mul_add": (x, y, z), "cbrt": (x,), "aq_tail": (z * np.float32(8.0),),
        "exp": (z * np.float32(8.0),), "log": (x,),
    }


def reference(op, *args):
    """The op in float64 on the float32 arguments, rounded once to float32."""
    a = [np.asarray(v, np.float64) for v in args]
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        r = {
            "exp2": lambda: np.exp2(a[0]), "log2": lambda: np.log2(a[0]),
            "sqrt": lambda: np.sqrt(a[0]), "rsqrt": lambda: 1.0 / np.sqrt(a[0]),
            "div": lambda: a[0] / a[1], "recip": lambda: 1.0 / a[0],
            "mul_add": lambda: a[0] * a[1] + a[2], "cbrt": lambda: np.cbrt(a[0]),
            "aq_tail": lambda: (np.exp2(a[0] * np.float64(LOG2E)) * np.float64(np.float32(0.7))
                                + np.float64(np.float32(0.1))),
            "exp": lambda: np.exp(a[0]), "log": lambda: np.log(a[0]),
        }[op]()
    return r.astype(np.float32)


def ulp_distance(a, b):
    """|a - b| in float32 ulp (bit patterns as ordered integers), per value."""
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def column(got, want):
    """(share of values that differ, max ulp), NaN equal to NaN."""
    got, want = np.asarray(got), np.asarray(want)
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    u = ulp_distance(got, want)[~same]
    return float((~same).mean()), int(u.max()) if u.size else 0


def port_form(op, *args):
    """The port's deterministic form of op (sqrt, cbrt), or None."""
    t = torch.from_numpy(np.ascontiguousarray(args[0]))
    if op == "sqrt":  # ops/aq_kernel.aq_field_plain
        return torch.sqrt(t.to(torch.float64)).to(torch.float32).numpy()
    if op == "cbrt":  # ops/pipeline._cbrt
        return torch.pow(t.to(torch.float64), 1.0 / 3.0).to(torch.float32).numpy()
    return None


def probe(device="cpu", log2_size=19):
    """{op: {column: [share, max ulp]}} on this host's CPU and, with
    device "cuda", the card: torch-cuda, the kernel's three builds
    (ops/probe_kernels.FLAG_SETS) and kernel_vs_plain (probe_elementwise
    at the port's flags against torch on the card)."""
    x, y, z, _, _ = probe_inputs(log2_size)
    cuda = torch.device(device).type == "cuda"
    out = {}
    for op, args in op_arguments(x, y, z).items():
        want = reference(op, *args)
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        row = {"torch-cpu": column(PK.probe_elementwise_plain(op, *cpu).numpy(), want)}
        form = port_form(op, *args)
        if form is not None:
            row["port"] = column(form, want)
        if cuda:
            dev = [t.to(device) for t in cpu]
            plain = PK.probe_elementwise_plain(op, *dev)
            row["torch-cuda"] = column(plain.cpu().numpy(), want)
            for fs in PK.FLAG_SETS:
                got = PK.probe_elementwise(op, *dev, flags=fs)
                row[f"kernel:{fs}"] = column(got.cpu().numpy(), want)
                if fs == "port":
                    row["kernel_vs_plain"] = column(got.cpu().numpy(), plain.cpu().numpy())
        out[op] = {k: list(v) for k, v in row.items()}
    return out


def probe_dot(device="cpu"):
    """probe_dot_i8 on the probe's one-hot permutation: (mismatches against
    the numpy int32 product, mismatches against the plain version)."""
    _, _, _, q, perm = probe_inputs()
    ref = q.astype(np.int32) @ perm.astype(np.int32)
    a, b = torch.from_numpy(q).to(device), torch.from_numpy(perm).to(device)
    got = PK.probe_dot_i8(a, b).cpu().numpy()
    plain = PK.probe_dot_i8_plain(a, b).cpu().numpy()
    return int((got != ref).sum()), int((got != plain).sum())


def main(argv=None):
    p = argparse.ArgumentParser(prog="jxl_tiny_tpu_torch.tools.probe_op_exactness")
    p.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the CPU alone")
    p.add_argument("--log2-size", type=int, default=19)
    args = p.parse_args(argv)
    from ..transfer import resolve_device

    dev = resolve_device(args.device)
    for op, row in probe(dev, args.log2_size).items():
        print(json.dumps({"op": op, **row}))
    bad_ref, bad_plain = probe_dot(dev)
    print(json.dumps({"op": "dot_i8 [256,128] x [128,128]", "mismatches_vs_int32_product": bad_ref,
                      "mismatches_vs_plain": bad_plain, "device": str(dev)}))


if __name__ == "__main__":
    main()
