"""The port's verification decoder against the JAX package's on mutated
codestreams: the bit-flip checks of tests/test_fuzz_decode.py, made
differential.

For every mutant (one bit flipped, at the positions tests/test_fuzz_decode
draws: seeded, stratified over 16 sixteenths of the stream, optionally
outside the global table sections), the port's decode_jxl(crop=False)
raises the port's DecodeError exactly when the JAX decoder raises its own,
and otherwise returns an array equal to the JAX decoder's. Any other
exception fails the test. The default cases take the reference encoder's
golden tiny64 and odd131x77 streams (seed 1234); the `slow` ones a
multi-section stream, the static tier's and a batch's, each from the
port's own encoder on the CPU (seed 99)."""
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu.decode.decoder import decode_jxl as j_decode
from jxl_tiny_tpu.errors import DecodeError as JDecodeError

from test_fuzz_decode import _fuzz_image

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.decode.decoder import decode_jxl, section_spans
from jxl_tiny_tpu_torch.errors import DecodeError

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "testdata", "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode(fn, error, data):
    """fn(data, crop=False), or None when it raises `error`."""
    try:
        return fn(data, crop=False)
    except error:
        return None


def _differential(data, n, seed, mask_globals=False):
    """tests/test_fuzz_decode._fuzz's mutants, each through both decoders.
    Returns (mutants both reject, mutants both accept with other pixels,
    mutants both accept with the original pixels)."""
    base = decode_jxl(data, crop=False)
    assert np.array_equal(base, j_decode(data, crop=False))
    rng = np.random.RandomState(seed)
    allowed = np.ones(len(data), bool)
    if mask_globals:
        for name, a, b in section_spans(data):
            if name.endswith("global"):
                allowed[a:b] = False
    pool = np.nonzero(np.repeat(allowed, 8))[0]
    strata = np.linspace(0, len(pool), 17).astype(int)
    err = diff = same = 0
    for i in range(n):
        s = i % 16
        pos = int(pool[rng.randint(strata[s], max(strata[s + 1], strata[s] + 1))])
        m = bytearray(data)
        m[pos // 8] ^= 1 << (pos % 8)
        got = _decode(decode_jxl, DecodeError, bytes(m))
        want = _decode(j_decode, JDecodeError, bytes(m))
        assert (got is None) == (want is None), f"bit {pos}: port raised {got is None}"
        if got is None:
            err += 1
            continue
        assert got.dtype == want.dtype and np.array_equal(got, want), f"bit {pos}"
        if got.shape == base.shape and np.array_equal(got, base):
            same += 1
        else:
            diff += 1
    return err, diff, same


@pytest.mark.parametrize("name,n,masked", [("tiny64", 400, False), ("odd131x77", 300, False),
                                           ("tiny64", 300, True), ("odd131x77", 300, True)])
def test_bitflip_golden_matches_jax(name, n, masked):
    with open(os.path.join(GOLDEN, f"{name}.jxl"), "rb") as f:
        data = f.read()
    err, diff, same = _differential(data, n, 1234, masked)
    print(f"{name}{' (global tables masked)' if masked else ''}: {n} mutants, both decoders "
          f"reject {err}, accept with other pixels {diff}, with the same pixels {same}")
    assert err + diff + same == n and err >= 0.3 * n


def _stream(kind):
    img = _fuzz_image()
    if kind == "multisection":
        return TE.encode_image(img, 1.0)
    if kind == "static_tier":
        return TE.encode_image_device(img, 1.0, upload_dtype=None, device="cpu",
                                      config=EncoderConfig(optimize_code=False))
    return TE.encode_batch_device([img, np.ascontiguousarray(img[:, ::-1])], 1.0,
                                  upload_dtype=None, device="cpu")[1]


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["multisection", "static_tier", "batch_stream"])
def test_bitflip_port_stream_matches_jax(kind):
    """test_bitflip_fuzz_multisection, _static_tier and _batch_stream of
    tests/test_fuzz_decode.py, on the port's own streams."""
    err, diff, same = _differential(_stream(kind), 300, 99)
    print(f"{kind}: 300 mutants, both decoders reject {err}, accept with other pixels "
          f"{diff}, with the same pixels {same}")
    assert err + diff + same == 300 and err >= 0.3 * 300
