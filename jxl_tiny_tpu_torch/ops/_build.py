"""Build the CUDA kernels under csrc/ with nvcc at first use and load them
with ctypes.

Each csrc/<name>.cu becomes build/jxl_tiny_tpu_torch/<hash>/lib<name>.so,
compiled for sm_90a by one nvcc process per source, all started together.
The hash covers every source and the flags, so an edit rebuilds. The
libraries export plain `extern "C"` launchers that take device pointers and
a stream as integers and return cudaGetLastError(); nothing here needs
torch's headers or ninja.

`-fmad=false` is load-bearing: without it nvcc contracts a*b+c into FMA
and the kernels stop matching their plain torch versions bit for bit.
Every kernel of the encode is built with NVCC_FLAGS; a build may take other
flags (`build_all(flags=...)`, `load(..., flags=...)`: the exactness probe
builds csrc/probe.cu at nvcc's own float flags too), and lands in the
directory of its own hash.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "jxl_tiny_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs = {}


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
