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


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every csrc/*.cu that is not built yet, in parallel.

    Returns {kernel source name: library path}. Raises with nvcc's output
    when a source fails to compile."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    libs, procs = {}, []
    for src in _sources():
        lib = out_dir / f"lib{src.stem}.so"
        libs[src.stem] = lib
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
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


def load(name: str, bind) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, built on first use; `bind`
    sets its launchers' argtypes/restype once, right after loading."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all()[name]))
            bind(lib)
            _libs[name] = lib
        return _libs[name]


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
