"""Debug mode's checked kernels (utils/debug.debug_mode(checked_kernels=True),
ops/_build.CHECKED_FLAGS, csrc/check.cuh): the counterpart of the JAX
package's interpreted Pallas kernels with bounds semantics.

On the CPU: both switches set and restored; the checked flags and their
build directory; every launcher of the six checked sources against its
ctypes binding (parsed from the sources, so an ABI mismatch shows before a
call to the card); the fault record's path from a launch to IndexError;
the encode's bytes inside debug mode. Tests marked `gpu` hold every checked
kernel against its normal build and plain version and inject one fault a
kernel; they skip here. The machine with the card has no JAX, and this
module imports none:

    python -m pytest tests/test_torch_debug_checked.py -q -m gpu --noconftest
"""
import os
import re

import pytest
import torch

from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import _build
from jxl_tiny_tpu_torch.ops import aq_kernel as AQ
from jxl_tiny_tpu_torch.ops import pack_kernels as PK
from jxl_tiny_tpu_torch.ops import quantize_kernel as QK
from jxl_tiny_tpu_torch.ops import strategy_kernel as SK
from jxl_tiny_tpu_torch.ops import tokenize_kernel as TK
from jxl_tiny_tpu_torch.tools import checked_kernels as CK
from jxl_tiny_tpu_torch.utils import debug as D
from jxl_tiny_tpu_torch.utils import debug_mode

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")
BINDS = {"aq": AQ._bind, "strategy": SK._bind, "quantize": QK._bind, "tokenize": TK._bind,
         "compact": PK._bind_compact, "bitpack": PK._bind_bitpack}
HOST_POINTERS = {"consts", "params"}  # launcher arguments that point to host memory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _switches():
    return D._NAN_CHECKS.get(), D.checked_kernels()


def test_debug_mode_sets_and_restores_both_switches():
    assert _switches() == (False, False)
    with debug_mode():
        assert _switches() == (True, True)
        with debug_mode(nan_checks=False):
            assert _switches() == (False, True)
        with debug_mode(checked_kernels=False):
            assert _switches() == (True, False)
        assert _switches() == (True, True)
    assert _switches() == (False, False)
    with pytest.raises(KeyError):
        with debug_mode(nan_checks=False):
            assert _switches() == (False, True)
            raise KeyError("inside")
    assert _switches() == (False, False)


def test_checked_flags_build_into_their_own_directory():
    assert _build.CHECKED_FLAGS == _build.NVCC_FLAGS + ["-DJXL_CHECKED=1", "-lineinfo"]
    for flag in ("-fmad=false", "-prec-div=true", "-prec-sqrt=true", "arch=compute_90a,code=sm_90a"):
        assert flag in _build.CHECKED_FLAGS
    checked, normal = _build.build_dir(_build.CHECKED_FLAGS), _build.build_dir()
    assert checked != normal
    assert checked.parent == normal.parent == _build.BUILD_ROOT
    assert _build.build_dir(list(_build.CHECKED_FLAGS)) == checked
    assert set(_build.CHECKED_SOURCES) == set(BINDS)
    assert "probe" not in _build.CHECKED_SOURCES


class _Lib:
    """Stands in for a ctypes library: records what a bind function sets."""

    def __init__(self):
        self.__dict__["bound"] = {}

    def __getattr__(self, name):
        return self.bound.setdefault(name, type("Fn", (), {"argtypes": None, "restype": None})())


@pytest.mark.parametrize("source", sorted(BINDS))
def test_launchers_match_their_bindings(source):
    """Every extern "C" launcher of the source takes as many arguments as its
    ctypes binding declares, and ends (after the stream) in one long long
    extent for each buffer on the card."""
    params = _build.launcher_params((_build.CSRC / f"{source}.cu").read_text())
    lib = _Lib()
    BINDS[source](lib)
    assert set(lib.bound) == set(params) and params
    for name, fn in lib.bound.items():
        assert len(fn.argtypes) == len(params[name]), name
        names = [p.split()[-1].lstrip("*") for p in params[name]]
        stream = next(i for i, p in enumerate(params[name]) if p.startswith("void*"))
        extents = names[stream + 1:]
        buffers = [n for p, n in zip(params[name][:stream], names) if "*" in p
                   and n not in HOST_POINTERS]
        assert all(p.startswith("long long n_") for p in params[name][stream + 1:]), name
        assert extents == [f"n_{b}" for b in buffers], name
        assert fn.argtypes[stream + 1:] == [_build.L] * len(buffers), name


def test_fault_record_matches_check_cuh():
    """jxl_fault_take's signature and record size, and the kernel ids,
    as csrc/check.cuh declares them; each source guards with its own ids."""
    text = (_build.CSRC / "check.cuh").read_text()
    params = _build.launcher_params(text)
    lib = _Lib()
    _build._bind_fault(lib)
    assert len(lib.bound["jxl_fault_take"].argtypes) == len(params["jxl_fault_take"]) == 1
    assert int(re.search(r"JXL_FAULT_WORDS = (\d+);", text).group(1)) == _build.FAULT_WORDS
    ids = {int(v): k for k, v in re.findall(r"(JXL_\w+) = (\d+),", text)}
    assert sorted(ids) == sorted(_build.FAULT_KERNELS)
    for kid, (kernel, source) in _build.FAULT_KERNELS.items():
        used = set(re.findall(r"JXL_CHECK(?:_N)?\((JXL_\w+)",
                              (_build.CSRC / source).read_text()))
        assert ids[kid] in used, (kernel, source)
        assert all(u in ids.values() and _build.FAULT_KERNELS[
            next(k for k, v in ids.items() if v == u)][1] == source for u in used)


@pytest.mark.parametrize("kernel", sorted(CK.INJECT))
def test_injection_targets_a_guard(kernel):
    """Each injected fault's buffer is named by at least one guard of the
    kernel's source."""
    source = next(src for kn, src in _build.FAULT_KERNELS.values() if kn == kernel)
    assert CK.guard_lines((_build.CSRC / source).read_text(), CK.INJECT[kernel][1])


def test_launch_reads_the_fault_record_only_in_debug_mode(monkeypatch):
    """Outside debug mode a launch is the launcher's call alone; inside, the
    checked library is loaded and its record read after the launch: none
    passes, a fault raises IndexError with the kernel, line, block, thread,
    index and extent. Each launch that passes counts once on its wrapper."""
    seen, record = [], [0] * _build.FAULT_WORDS

    class Wrapper:
        launches = 0

    w = Wrapper()

    class Lib:
        def entry(self, *args):
            seen.append(("entry", args))
            return 0

        def jxl_fault_take(self, rec):
            seen.append(("take",))
            for i, v in enumerate(record):
                rec[i] = v
            return 0

    monkeypatch.setattr(_build, "load", lambda name, bind, flags=None: (
        seen.append(("load", name, flags)), Lib())[1])
    _build.launch(w, "compact", None, "entry", "compact_rows", (1, 2), [30, 40])
    assert seen == [("load", "compact", None), ("entry", (1, 2, 30, 40))]
    assert w.launches == 1
    seen.clear()
    with debug_mode():
        _build.launch(w, "compact", None, "entry", "compact_rows", (1, 2), [30, 40])
        assert seen == [("load", "compact", _build.CHECKED_FLAGS), ("entry", (1, 2, 30, 40)),
                        ("take",)]
        assert w.launches == 2
        record[:] = [1, 6, 227, 9, 0, 0, 96, 0, 0, 4096, 4095, 3]
        with pytest.raises(IndexError, match=r"copy_sections: .*csrc/compact\.cu:227, block "
                           r"\(9, 0, 0\) thread \(96, 0, 0\): index 4096 outside extent 4095 "
                           r"\(3 faulting"):
            _build.launch(w, "compact", None, "entry", "copy_sections", (1, 2), [30, 40])
        assert w.launches == 2  # the faulting launch is not counted


@pytest.mark.parametrize("tier", ["default", "static"])
def test_encode_inside_debug_mode_on_cpu(tier):
    """On the CPU the switch changes nothing: tiny64 inside debug_mode()
    gives the bytes of the encode outside it."""
    img = read_pfm(os.path.join(TESTDATA, "tiny64.pfm"))
    config = EncoderConfig(optimize_code=tier == "default")
    want = TE.encode_image_device(img, 1.0, config=config, device="cpu")
    with debug_mode():
        assert TE.encode_image_device(img, 1.0, config=config, device="cpu") == want


@pytest.fixture(scope="module")
def small_calls():
    """Every kernel call of gradient512's encode, recorded once a module
    run (tools/checked_kernels.small_calls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CK.small_calls(torch.device("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(CK.INJECT))
def test_checked_kernel_equals_normal_on_card(small_calls, kernel):
    """Every call gradient512's encode makes (bitpack_groups_var: seeded
    fields) through the checked build equals the normal build and the
    plain version, with no fault."""
    rec = CK.hold_checked(kernel, small_calls[kernel])
    assert rec["calls"] and rec["mismatches_normal"] == 0 and rec["mismatches_plain"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(CK.INJECT))
def test_injected_fault_on_card(small_calls, kernel):
    """One output's extent cut one element short: the fault names the
    kernel and a guard line of that buffer, the canary after the cut is
    untouched, and the next normal launch still equals the plain version."""
    r = CK.inject(kernel, small_calls[kernel][0])
    assert r["fault"] is not None, r
    assert r["fault"]["kernel"] == kernel and r["fault"]["line"] in r["expected_lines"]
    assert r["canary_intact"] and r["normal_after"] == 0 and r["ok"]
