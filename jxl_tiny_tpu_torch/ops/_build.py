"""Build the CUDA kernels under csrc/ with nvcc at first use and load them
with ctypes.

Each csrc/<name>.cu becomes build/jxl_tiny_tpu_torch/<hash>/lib<name>.so,
compiled for sm_90a by one nvcc process per source, all started together.
The hash covers every source and the flags, so an edit rebuilds. The
libraries export plain `extern "C"` launchers that take device pointers and
a stream as integers, then each buffer's extent, and return
cudaGetLastError(); nothing here needs torch's headers or ninja.

`-fmad=false` is load-bearing: without it nvcc contracts a*b+c into FMA
and the kernels stop matching their plain torch versions bit for bit.
Every kernel of the encode is built with NVCC_FLAGS; a build may take other
flags (`build_all(flags=...)`, `load(..., flags=...)`: the exactness probe
builds csrc/probe.cu at nvcc's own float flags too), and lands in the
directory of its own hash.

The checked build (CHECKED_FLAGS: -DJXL_CHECKED=1 -lineinfo, csrc/check.cuh)
of the six encode sources tests every kernel access against its buffer's
extent. `launch` takes it inside utils/debug.debug_mode(checked_kernels=True)
and reads the fault record after each launch.

`launch` also counts each launch on its kernel wrapper (`launches`), the
one place that does; while a thread captures a program as a CUDA graph
(ops/programs, `recording`), that thread's launches go to the capture's
record instead, since a capture runs nothing on the card.
"""
import contextlib
import contextvars
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

from ..utils import debug

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "jxl_tiny_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
]

# The checked build: the default flags (float semantics included), the
# bounds checks of csrc/check.cuh, and line tables for the fault reports.
CHECKED_FLAGS = NVCC_FLAGS + ["-DJXL_CHECKED=1", "-lineinfo"]
CHECKED_SOURCES = ("aq", "strategy", "quantize", "tokenize", "compact", "bitpack")
# check.cuh's kernel ids: (kernel, source file).
FAULT_KERNELS = {1: ("aq_field", "aq.cu"), 2: ("estimate_partials", "strategy.cu"),
                 3: ("quantize_cells", "quantize.cu"), 4: ("tokenize_rows", "tokenize.cu"),
                 5: ("compact_rows", "compact.cu"), 6: ("copy_sections", "compact.cu"),
                 7: ("bitpack_groups_var", "bitpack.cu")}
FAULT_WORDS = 12  # check.cuh's JXL_FAULT_WORDS

_lock = threading.Lock()
_libs = {}
_RECORD = contextvars.ContextVar("jxl_tiny_tpu_torch_capture_record", default=None)


def _nvcc():
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return cand


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir(flags=None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS if flags is None else flags).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(flags=None, names=None) -> dict:
    """Compile every csrc/*.cu (or those whose stem is in `names`) that is
    not built yet with `flags` (default NVCC_FLAGS), in parallel.

    Returns {kernel source name: library path}. Raises with nvcc's output
    when a source fails to compile."""
    flags = NVCC_FLAGS if flags is None else flags
    out_dir = build_dir(flags)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    libs, procs = {}, []
    for src in _sources():
        if names is not None and src.stem not in names:
            continue
        lib = out_dir / f"lib{src.stem}.so"
        libs[src.stem] = lib
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for src, tmp, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, lib)  # atomic: concurrent loaders never see a partial file
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return libs


def load(name: str, bind, flags=None) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu with `flags` (default
    NVCC_FLAGS, which builds every source at first use), built on first
    use; `bind` sets its launchers' argtypes/restype once, right after
    loading."""
    key = name if flags is None else (name, tuple(flags))
    with _lock:
        if key not in _libs:
            path = build_all() if flags is None else build_all(flags, (name,))
            lib = ctypes.CDLL(str(path[name]))
            bind(lib)
            _libs[key] = lib
        return _libs[key]


P, I = ctypes.c_void_p, ctypes.c_int  # launcher argument types
L = ctypes.c_longlong  # a buffer's extent (elements)


def launcher_params(text):
    """{name: [parameter declarations]} of every `extern "C" int name(...)`
    definition in a CUDA source's text."""
    out = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', text):
        params = [p.strip() for p in m.group(2).split(",")]
        out[m.group(1)] = [p for p in params if p and p != "void"]
    return out


def _bind_fault(lib):
    lib.jxl_fault_take.argtypes = [P]
    lib.jxl_fault_take.restype = I


def take_fault(lib):
    """A checked library's fault record, cleared for the next launch (the
    call synchronizes the device). None when no access was out of bounds,
    else dict(kernel, source, line, block, thread, index, extent, faults)."""
    rec = (ctypes.c_longlong * FAULT_WORDS)()
    check(lib.jxl_fault_take(rec), "jxl_fault_take")
    if not rec[0]:
        return None
    kernel, source = FAULT_KERNELS.get(rec[1], (f"kernel id {rec[1]}", "?"))
    return dict(kernel=kernel, source=source, line=rec[2], block=tuple(rec[3:6]),
                thread=tuple(rec[6:9]), index=rec[9], extent=rec[10], faults=rec[11])


def fault_message(f):
    return (f"{f['kernel']}: out-of-bounds access at csrc/{f['source']}:{f['line']}, block "
            f"{f['block']} thread {f['thread']}: index {f['index']} outside extent "
            f"{f['extent']} ({f['faults']} faulting accesses in the launch, each skipped)")


def checked_library(name, bind):
    """csrc/<name>.cu's checked build, loaded (built at first use; a build
    that fails raises), with its launchers and jxl_fault_take bound."""
    return load(name, lambda lib: (bind(lib), _bind_fault(lib)), CHECKED_FLAGS)


@contextlib.contextmanager
def recording():
    """Inside the block this thread's launches are counted in the Counter
    it yields ({wrapper: launches}), not on the wrappers: the block
    captures a CUDA graph (ops/programs), whose replays add the record."""
    token = _RECORD.set(Counter())
    try:
        yield _RECORD.get()
    finally:
        _RECORD.reset(token)


def recording_active() -> bool:
    """True while this thread captures (inside `recording`)."""
    return _RECORD.get() is not None


def launch(wrapper, name, bind, entry, what, args, extents):
    """Call launcher `entry` of csrc/<name>.cu with args (the stream
    last) and the extents of its buffers (elements, in the order of the
    pointers); raise when the launch fails, else count it on `wrapper`
    (or in the capture's record, see `recording`). Inside debug_mode(
    checked_kernels=True) the library is the checked build (built at first
    use; a build that fails raises), and the fault record is read after the
    launch, which synchronizes: an out-of-bounds access raises IndexError
    naming the kernel, the source line, the block and thread, the index and
    the extent. Outside it nothing but the launch happens."""
    if not debug.checked_kernels():
        check(getattr(load(name, bind), entry)(*args, *extents), what)
    else:
        lib = checked_library(name, bind)
        check(getattr(lib, entry)(*args, *extents), what)
        fault = take_fault(lib)
        if fault is not None:
            raise IndexError(fault_message(fault))
    rec = _RECORD.get()
    if rec is None:
        wrapper.launches += 1
    else:
        rec[wrapper] += 1


def check(rc: int, what: str):
    """Raise when a launcher reports a CUDA error (launch refused, bad
    configuration): such a launch never ran and synchronize() would not
    report it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, dtype, shape, what):
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
