"""The port's utilities (jxl_tiny_tpu_torch/utils/): profiling.py (StageTimer,
device_time, busy_share, profile_trace, encode_report, the CLI) and debug.py
(debug_mode), on the CPU against the JAX package's utils where both have
them (tests/test_utils.py:20-48). Tests marked `gpu` run the card-only
parts and skip here; the machine with the card runs them with

    python -m pytest tests/test_torch_utils.py -q -m gpu --noconftest
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.decode import decode_jxl
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.utils import StageTimer, debug_mode, encode_report, profile_trace
from jxl_tiny_tpu_torch.utils import debug as D
from jxl_tiny_tpu_torch.utils import profiling as PR

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")


def _img(seed=9, h=96, w=128):
    """tests/test_utils.py's image."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.4 * np.sin(xx * 0.1),
            0.5 + 0.3 * np.cos(yy * 0.08),
            0.4 + 0.2 * np.sin((xx + yy) * 0.05),
        ]
    ).astype(np.float32)
    return np.clip(img + rng.randn(3, h, w).astype(np.float32) * 0.02, 0, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_card_waits(monkeypatch):
    """Any synchronize of a card fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("waited for a card")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_stage_timer(no_card_waits):
    """Stage names and the report's form; a CPU tensor (or a tree of them)
    as `sync` does not wait."""
    t = StageTimer()
    with t.stage("a", sync=torch.ones(3)):
        pass
    with t.stage("b", sync={"x": [torch.zeros(2), (torch.ones(1),)]}):
        pass
    with t.stage("a"):
        pass
    rep = t.report()
    assert set(rep["stages_ms"]) == {"a", "b"}
    assert rep["total_s"] >= 0 and all(v >= 0 for v in rep["stages_ms"].values())


def test_stage_timer_wrap_restores(no_card_waits):
    """wrap times every call of a module function as one stage, returns
    its results, and restore() puts the function back."""
    t = StageTimer()
    real = PL.to_xyb
    restore = t.wrap(PL, "to_xyb", sync=True, label="xyb")
    try:
        assert PL.to_xyb is not real
        groups = torch.rand(1, 3, 256, 256, generator=torch.Generator().manual_seed(0))
        assert torch.equal(PL.to_xyb(groups), real(groups))
        PL.to_xyb(groups)
    finally:
        restore()
    assert PL.to_xyb is real
    assert list(t.report()["stages_ms"]) == ["xyb"]


def test_encode_report_matches_jax():
    """The port's encode_report on the CPU gives the JAX package's bytes for
    the same image, decoding to (3, 96, 128), and names its device."""
    from jxl_tiny_tpu.utils import encode_report as jax_encode_report

    img = _img()
    data, rep = encode_report(img, 1.0, repeats=1, device="cpu", upload_dtype=None)
    want, _ = jax_encode_report(img, 1.0, repeats=1, upload_dtype=None)
    assert data == want
    assert rep["bytes"] == len(data) > 0 and rep["mps_best"] > 0
    assert rep["device"] == "cpu" and "card" not in rep and "program_a_ms" not in rep
    assert len(rep["times_s"]) == 1
    assert decode_jxl(data).shape == (3, 96, 128)


def test_encode_report_without_card_raises(monkeypatch):
    """device=None means the card; without one the report raises instead
    of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_report(_img(), 1.0, repeats=1)


def test_profile_trace_writes_a_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profile_trace(d) as logdir:
        PL.to_xyb(torch.rand(1, 3, 256, 256))
    assert logdir == d
    with open(os.path.join(d, "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_profiling_cli_cpu(capsys, tmp_path, monkeypatch):
    """python -m jxl_tiny_tpu_torch.utils.profiling input.pfm --device cpu
    [--trace] prints one JSON line; the trace goes under $TMPDIR."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = os.path.join(TESTDATA, "tiny64.pfm")
    PR.main([path, "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["bytes"] > 0 and len(rep["times_s"]) == 3
    PR.main([path, "--device", "cpu", "--trace"])
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["trace"] == os.path.join(str(tmp_path), "jxl_torch_trace", "trace.json")
    assert os.path.exists(rep["trace"]) and len(rep["times_s"]) == 1


def test_debug_mode_bytes_equal():
    """Debug mode changes no byte (the NaN checks pass on finite input)."""
    img = _img()
    want = TE.encode_image_device(img, 1.0, device="cpu")
    with debug_mode():
        assert D._NAN_CHECKS.get()
        got = TE.encode_image_device(img, 1.0, device="cpu")
    assert got == want
    assert decode_jxl(got).shape == (3, 96, 128)


@pytest.mark.parametrize("upload_dtype", [None, np.float16])
def test_debug_mode_nan_names_first_stage(upload_dtype):
    """A NaN pixel raises FloatingPointError at the first stage whose output
    holds it (the group tiles), naming the group; debug mode is off again
    after the exception."""
    img = _img(h=96, w=384)  # two groups; the NaN in the second
    img[1, 40, 300] = np.nan
    with pytest.raises(FloatingPointError, match=r"extract_groups, group 1"):
        with debug_mode():
            TE.encode_image_device(img, 1.0, upload_dtype=upload_dtype, device="cpu")
    assert not D._NAN_CHECKS.get()


def test_debug_mode_nests_and_restores():
    """nan_check names the first group holding a NaN; nested blocks keep
    the checks on until the outer one ends; outside, nothing is checked."""
    groups = torch.zeros((3, 3, 4, 4))
    groups[2, 1, 0, 0] = float("nan")
    with debug_mode():
        with debug_mode():
            with pytest.raises(FloatingPointError, match="stage, group 2"):
                D.nan_check("stage", groups)
        with pytest.raises(FloatingPointError, match="stage, group 2"):
            D.nan_check("stage", torch.zeros(3, dtype=torch.int32), groups)
        D.nan_check("stage", groups[:2])
    assert not D._NAN_CHECKS.get()
    D.nan_check("stage", groups)  # outside debug mode: nothing


@pytest.mark.gpu
def test_device_time_and_busy_share_on_card(cuda):
    x = torch.rand(1 << 22, device=cuda)
    ms, hidden, queue_ms = PR.device_span(lambda: x * 2, 5)
    assert ms > 0 and hidden and queue_ms > 0
    assert PR.device_time(lambda: x * 2, 5) > 0
    share = PR.busy_share(lambda: [x * 2 for _ in range(10)])
    assert share is None or 0 < share["busy_ms"] and share["top"]


@pytest.mark.gpu
def test_encode_report_on_card(cuda):
    img = read_pfm(os.path.join(TESTDATA, "gradient512.pfm"))
    data, rep = encode_report(img, 1.0, repeats=2)
    assert len(data) == 11680 and rep["program_a_ms"] > 0 and rep["program_b_ms"] > 0
    assert rep["program_a_queue_ms"] > 0 and rep["program_ms_are"] == "device time"
    assert rep["card"] and rep["device"].startswith("cuda")


@pytest.mark.gpu
def test_debug_mode_on_card(cuda):
    """Debug mode runs the kernels on the card, and with kernels=False
    their plain versions: the bytes of the encode outside it either way;
    every kernel launches in the first, none in the second."""
    from jxl_tiny_tpu_torch.tools import kernel_check as KC

    img = read_pfm(os.path.join(TESTDATA, "gradient512.pfm"))
    want = TE.encode_image_device(img, 1.0)
    wrappers, _ = KC.on_path_kernels()
    for kernels in (True, False):
        for wr in wrappers.values():
            wr.launches = 0
        with debug_mode():
            got = TE.encode_image_device(img, 1.0, kernels=kernels)
        assert got == want
        assert [wr.launches > 0 for wr in wrappers.values()] == [kernels] * len(wrappers)


def test_debug_cli_cpu(capsys):
    """python -m jxl_tiny_tpu_torch.utils.debug input.pfm [--static-codes]
    (the program compute-sanitizer runs) prints the encode's size."""
    path = os.path.join(TESTDATA, "tiny64.pfm")
    D.main([path, "--device", "cpu", "--static-codes"])
    out = capsys.readouterr().out.strip()
    want = TE.encode_image_device(read_pfm(path), 1.0, device="cpu",
                                  config=EncoderConfig(optimize_code=False))
    assert out == f"{path}: {len(want)} bytes"
