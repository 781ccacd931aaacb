"""The port's verification decoder (jxl_tiny_tpu_torch/decode/) against the
JAX package's, on the CPU: both are numpy, so the decoded arrays must be
equal, element for element.

(a) the seven reference streams of testdata/golden/ decode to the JAX
    decoder's arrays, pre-filter, with the restoration filters
    (filters=True) and as XYB (return_xyb=True); photo8mp.jxl (4 DC groups,
    the only multi-DC-group stream; ~30 s a decode) pre-filter only
(b) malformed streams (the structural mutations of tests/test_fuzz_decode:
    truncations, an empty file, appended bytes, a flipped signature bit)
    raise DecodeError, as in the JAX decoder
(c) `python -m jxl_tiny_tpu_torch.decode in.jxl out.pfm` writes the decoded
    image (write_pfm, read back by read_pfm), and reports a bad stream
(d) the port's BitReader: reads past the end and nonzero padding raise"""
import os
import subprocess
import sys

import numpy as np
import pytest

from jxl_tiny_tpu.decode import decode_jxl as j_decode

from jxl_tiny_tpu_torch.bitstream.bit_reader import BitReader
from jxl_tiny_tpu_torch.decode import decode_jxl
from jxl_tiny_tpu_torch.decode.__main__ import main as decode_main
from jxl_tiny_tpu_torch.errors import DecodeError
from jxl_tiny_tpu_torch.io.pfm import read_pfm

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMALL = ["gradient512", "gradient512_d0.5", "gradient512_d2.0", "odd131x77",
         "photo256", "tiny64"]
MODES = {"plain": {}, "filters": dict(filters=True), "xyb": dict(return_xyb=True)}
CASES = [(name, mode) for name in SMALL for mode in MODES] + [("photo8mp", "plain")]


def _golden(name):
    with open(os.path.join(REPO, "testdata", "golden", f"{name}.jxl"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,mode", CASES)
def test_decode_matches_jax(name, mode):
    data = _golden(name)
    got = decode_jxl(data, **MODES[mode])
    want = j_decode(data, **MODES[mode])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _mutants():
    data = _golden("gradient512")
    flipped = bytearray(data)
    flipped[0] ^= 0x01  # the signature byte
    return {
        "drop_last_byte": data[:-1],
        "half": data[: len(data) // 2],
        "header_only": data[:20],
        "empty": b"",
        "trailing_zero": data + b"\x00",
        "middle_cut": data[:100] + data[150:],
        "signature_flip": bytes(flipped),
    }


@pytest.mark.parametrize("name", sorted(_mutants()))
def test_malformed_stream_raises(name):
    mutant = _mutants()[name]
    with pytest.raises(DecodeError):
        decode_jxl(mutant)
    with pytest.raises(Exception) as jax_err:  # the JAX decoder agrees
        j_decode(mutant)
    assert type(jax_err.value).__name__ == "DecodeError"


def test_decode_cli_round_trip(tmp_path):
    src = os.path.join(REPO, "testdata", "golden", "odd131x77.jxl")
    out = tmp_path / "odd.pfm"
    assert decode_main([src, str(out), "-q"]) == 0
    got = read_pfm(str(out))
    assert np.array_equal(got, decode_jxl(_golden("odd131x77")).astype(np.float32))
    bad = tmp_path / "bad.jxl"
    bad.write_bytes(_golden("odd131x77")[:30])
    assert decode_main([str(bad), str(tmp_path / "bad.pfm"), "-q"]) == 1


def test_decode_module_runs(tmp_path):
    """The module form, in a fresh interpreter."""
    out = tmp_path / "tiny.pfm"
    r = subprocess.run(
        [sys.executable, "-m", "jxl_tiny_tpu_torch.decode",
         os.path.join(REPO, "testdata", "golden", "tiny64.jxl"), str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "Decoded 64x64 pixels" in r.stderr
    assert read_pfm(str(out)).shape == (3, 64, 64)


def test_bit_reader_strict():
    r = BitReader(bytes([0b10110101, 0b11]))
    assert r.read(3) == 0b101 and r.peek(5) == 0b10110 and r.pos == 3
    r.skip(5)
    assert r.bits_remaining() == 8
    assert r.read(1) == 1
    with pytest.raises(DecodeError):
        r.zero_pad_to_byte()  # the padding's first bit is 1
    r = BitReader(b"\x00")
    with pytest.raises(DecodeError):
        r.read(9)
