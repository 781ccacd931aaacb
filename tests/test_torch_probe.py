"""The exactness probe (jxl_tiny_tpu_torch/tools/probe_op_exactness.py) and
its two kernels (csrc/probe.cu through ops/probe_kernels.py).

On the CPU, on 2^14 of the probe's values: the torch-CPU column and the
XLA:CPU column (jax.jit of the same op, which the port's probe never
imports), each against the float64 reference rounded once, are printed per
op; the port's deterministic sqrt and cbrt forms equal the reference on
every input; the kernels' plain versions equal numpy's float32 and int32
arithmetic, and the int8 product's plain version equals the JAX probe's
kern_i8 in Pallas interpret mode. Tests marked `gpu` hold both kernels
against their plain versions on the card (the tensor-core product also at
odd shapes and at one zig-zag chunk of photo8mp, [414720,128] x [128,128];
the elementwise kernel also at n % 4 != 0 and at a misaligned start) and
skip here; the machine with the card runs them with

    python -m pytest tests/test_torch_probe.py -q -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch.ops import probe_kernels as PK
from jxl_tiny_tpu_torch.tools import probe_op_exactness as PO

LOG2_SIZE = 14
# Correctly rounded in float32 on every device: the reference's value.
EXACT = ("div", "recip")
# Bit-equal to torch on the card when built with the port's flags
# (-fmad=false -prec-div=true -prec-sqrt=true).
EXACT_ON_CARD = ("div", "sqrt", "recip", "mul_add")


@pytest.fixture(scope="module")
def args():
    x, y, z, _, _ = PO.probe_inputs(LOG2_SIZE)
    return PO.op_arguments(x, y, z)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _xla(op):
    """The op as the JAX package writes it, jitted on XLA:CPU (imported
    here: the machine with the card has no JAX)."""
    import jax
    import jax.numpy as jnp

    f32 = np.float32
    return jax.jit({
        "exp2": jnp.exp2, "log2": jnp.log2, "sqrt": jnp.sqrt, "rsqrt": jax.lax.rsqrt,
        "div": lambda a, b: a / b, "recip": lambda a: 1.0 / a,
        "mul_add": lambda a, b, c: a * b + c, "cbrt": jnp.cbrt,
        "aq_tail": lambda v: jnp.exp2(v * f32(1.442695041)) * f32(0.7) + f32(0.1),
        "exp": jnp.exp, "log": jnp.log,
    }[op])


def test_inputs_are_the_probes():
    """The AQ ranges of tools/probe_op_exactness.py and its int8 pair."""
    x, y, z, q, perm = PO.probe_inputs(LOG2_SIZE)
    assert x.shape == y.shape == z.shape == (16, 1024) and x.dtype == np.float32
    assert x.min() > 0 and x.max() < 1.0001e4
    assert 0.5 <= y.min() and y.max() < 2.0 and -1.0 <= z.min() and z.max() < 1.0
    assert q.shape == (256, 128) and q.dtype == np.int8
    assert (perm.sum(0) == 1).all() and (perm.sum(1) == 1).all()


@pytest.mark.parametrize("op", list(PK.OPS))
def test_cpu_columns(op, args):
    """torch-CPU and XLA:CPU against the float64 reference rounded once."""
    a = args[op]
    want = PO.reference(op, *a)
    torch_cpu = PO.column(PK.probe_elementwise_plain(
        op, *(torch.from_numpy(np.ascontiguousarray(v)) for v in a)).numpy(), want)
    xla_cpu = PO.column(np.asarray(_xla(op)(*a)), want)
    print(f"{op}: torch-cpu {torch_cpu}, xla-cpu {xla_cpu} (share differing, max ulp; "
          f"{want.size} values)")
    if op in EXACT:
        assert torch_cpu == xla_cpu == (0.0, 0)
    if op == "mul_add":
        # XLA:CPU contracts a*b+c into one FMA inside a jit (one rounding);
        # torch rounds the product and the sum.
        assert xla_cpu == (0.0, 0) and torch_cpu[0] > 0
    else:
        assert max(torch_cpu[1], xla_cpu[1]) <= 64


@pytest.mark.parametrize("op", ["sqrt", "cbrt"])
def test_port_forms_are_correctly_rounded(op, args):
    """The port's float64 sqrt and cube root, rounded once, equal the
    reference on every input (torch's float32 CPU sqrt does not)."""
    a = args[op]
    assert PO.column(PO.port_form(op, *a), PO.reference(op, *a)) == (0.0, 0)


def test_elementwise_plain_matches_numpy(args):
    """The plain version of probe_elementwise computes numpy's float32 ops
    where they are single roundings (and a*b+c as two), and the wrapper
    takes it for CPU tensors without counting a launch."""
    before = PK.probe_elementwise.launches
    for op, f in (("div", lambda a, b: a / b), ("recip", lambda a: np.float32(1) / a),
                  ("mul_add", lambda a, b, c: a * b + c)):
        a = args[op]
        got = PK.probe_elementwise(op, *(torch.from_numpy(np.ascontiguousarray(v)) for v in a))
        assert np.array_equal(got.numpy().view(np.int32), f(*a).view(np.int32)), op
    assert PK.probe_elementwise.launches == before


def test_dot_i8_plain_matches_numpy():
    _, _, _, q, perm = PO.probe_inputs(19)
    want = q.astype(np.int32) @ perm.astype(np.int32)
    got = PK.probe_dot_i8(torch.from_numpy(q), torch.from_numpy(perm))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert PO.probe_dot("cpu") == (0, 0)


def _int8(rng, shape):
    return rng.randint(-128, 128, shape).astype(np.int8)


def _one_hot_or_random(b):
    """The probe's one-hot permutation, or random full-range int8 of its shape."""
    _, _, _, q, perm = PO.probe_inputs(19)
    return q, perm if b == "one-hot" else _int8(np.random.RandomState(7), perm.shape)


# name -> (A, B) as numpy int8, drawn from a seed
DOT_SHAPES = {
    "probe-one-hot": lambda: _one_hot_or_random("one-hot"),
    "probe-random": lambda: _one_hot_or_random("random"),
    "1x1x1": lambda: (_int8(np.random.RandomState(1), (1, 1)),
                      _int8(np.random.RandomState(2), (1, 1))),
    "77x40x24": lambda: (_int8(np.random.RandomState(3), (77, 40)),
                         _int8(np.random.RandomState(4), (40, 24))),
    "300x128x136": lambda: (_int8(np.random.RandomState(5), (300, 128)),
                            _int8(np.random.RandomState(6), (128, 136))),
}


@pytest.mark.parametrize("case", list(DOT_SHAPES))
def test_dot_i8_plain_shapes(case):
    """The plain version (int32 sums over K, no [M, K, N] intermediate)
    equals numpy's int32 product at the probe's pair and at odd shapes."""
    a, b = DOT_SHAPES[case]()
    got = PK.probe_dot_i8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("b", ["one-hot", "random"])
def test_dot_i8_plain_matches_pallas_interpret(b):
    """The plain version equals the JAX probe's kern_i8 (the int8
    dot_general with int32 sums inside a pl.pallas_call, as
    tools/probe_op_exactness.py writes it) run in interpret mode on the
    probe's inputs (imported here: the machine with the card has no JAX)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def kern_i8(a_ref, b_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(
            a_ref[...], b_ref[...], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    q, rhs = _one_hot_or_random(b)
    want = np.asarray(pl.pallas_call(
        kern_i8, out_shape=jax.ShapeDtypeStruct((256, 128), jnp.int32), interpret=True,
    )(jnp.asarray(q), jnp.asarray(rhs)))
    got = PK.probe_dot_i8(torch.from_numpy(q), torch.from_numpy(rhs)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", list(PK.OPS))
def test_probe_elementwise_on_card(op, args, cuda):
    """Kernel 1 at the port's flags against torch on the card: bit-equal
    for the correctly rounded ops; the others' distance is printed."""
    a = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for v in args[op]]
    before = PK.probe_elementwise.launches
    got = PK.probe_elementwise(op, *a)
    torch.cuda.synchronize()
    assert PK.probe_elementwise.launches == before + 1
    plain = PK.probe_elementwise_plain(op, *a)
    col = PO.column(got.cpu().numpy(), plain.cpu().numpy())
    print(f"{op}: kernel vs plain {col}; kernel vs reference "
          f"{PO.column(got.cpu().numpy(), PO.reference(op, *args[op]))}")
    if op in EXACT_ON_CARD:
        assert col == (0.0, 0)


@pytest.mark.gpu
def test_probe_other_flag_builds_on_card(args, cuda):
    """The nvcc-default and approx builds of csrc/probe.cu load and run;
    IEEE division stays exact at nvcc's defaults."""
    a = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for v in args["div"]]
    want = PO.reference("div", *args["div"])
    assert PO.column(PK.probe_elementwise("div", *a, flags="nvcc-default").cpu().numpy(),
                     want) == (0.0, 0)
    approx = PK.probe_elementwise("div", *a, flags="approx").cpu().numpy()
    assert PO.column(approx, want)[1] <= 2


@pytest.mark.gpu
def test_probe_dot_i8_on_card(cuda):
    before = PK.probe_dot_i8.launches
    assert PO.probe_dot(cuda) == (0, 0)
    assert PK.probe_dot_i8.launches == before + 1


ZIGZAG_ROWS = 135 * 3 * 1024  # one permutation chunk of the int8 zig-zag over photo8mp


def _card_dot_case(case, dev):
    """(A, B) int8 on the card: the CPU shapes, a K that is not a multiple
    of 16 with N % 4 != 0 (byte loads, scalar stores), a misaligned A (a
    view one element into its buffer), K and N past one 128 chunk with N %
    4 != 0 (16-byte A copies, scalar stores), K past one chunk with N % 16
    == 0 (16-byte B loads at every chunk), and the zig-zag chunk with
    one-hot and random full-range B."""
    rng = np.random.RandomState(11)
    if case in DOT_SHAPES:
        a, b = DOT_SHAPES[case]()
    elif case == "65x33x7":
        a, b = _int8(rng, (65, 33)), _int8(rng, (33, 7))
    elif case == "misaligned-A":
        flat = torch.from_numpy(_int8(rng, (1 + 77 * 40,))).to(dev)
        return flat[1:].view(77, 40), torch.from_numpy(_int8(rng, (40, 24))).to(dev)
    elif case == "200x320x258":
        a, b = _int8(rng, (200, 320)), _int8(rng, (320, 258))
    elif case == "130x256x32":
        a, b = _int8(rng, (130, 256)), _int8(rng, (256, 32))
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        big = torch.randint(-128, 128, (ZIGZAG_ROWS, 128), generator=g, device=dev,
                            dtype=torch.int32).to(torch.int8)
        _, perm = _one_hot_or_random("one-hot" if case == "zigzag-one-hot" else "random")
        return big, torch.from_numpy(perm).to(dev)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*DOT_SHAPES, "65x33x7", "misaligned-A", "200x320x258",
                                  "130x256x32", "zigzag-one-hot", "zigzag-random"])
def test_probe_dot_i8_tensor_cores_on_card(case, cuda):
    """The tensor-core kernel equals its plain version and numpy's exact
    product (float64: every sum is an integer below 2^53), and
    torch._int_mm where that takes the shape (M > 16, K and N multiples of 8)."""
    a, b = _card_dot_case(case, cuda)
    before = PK.probe_dot_i8.launches
    got = PK.probe_dot_i8(a, b)
    torch.cuda.synchronize()
    assert PK.probe_dot_i8.launches == before + 1
    assert torch.equal(got, PK.probe_dot_i8_plain(a, b))
    want = a.cpu().numpy().astype(np.float64) @ b.cpu().numpy().astype(np.float64)
    assert np.array_equal(got.cpu().numpy(), want.astype(np.int32))
    m, k = a.shape
    if m > 16 and k % 8 == 0 and b.shape[1] % 8 == 0:
        assert torch.equal(got, torch._int_mm(a.clone(), b))  # clone: an aligned A


@pytest.mark.gpu
@pytest.mark.parametrize("op", PO.EQUAL_ON_CARD)
def test_probe_elementwise_tails_on_card(op, args, cuda):
    """Bit-equal to torch on the card at n % 4 != 0 (float4 body, scalar
    tail) and at a start one element in (a misaligned view: scalar)."""
    full = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda).view(-1) for v in args[op]]
    for ins in ([t[:(1 << 13) + 3] for t in full], [t[1:] for t in full]):
        got = PK.probe_elementwise(op, *ins)
        want = PK.probe_elementwise_plain(op, *ins)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
