"""Build the native host packer (pack.cc) with g++ at first use and load it
with ctypes.

The library lands in build/jxl_tiny_tpu_torch/<hash>/libjxlpack.so, where
the hash covers the source and the flags: an edited source builds anew and
can never load an older binary. Nothing is built when the module is
imported. A host without g++ gets None from native_packer() and the
callers' numpy code instead; a source that fails to compile raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "pack.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "jxl_tiny_tpu_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_no_compiler = False


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"cpp-{h.hexdigest()[:16]}" / "libjxlpack.so"


def _build(lib: Path, cxx: str):
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libjxlpack.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file


def _bind(lib):
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.pack_bits.argtypes = [P, P, I64, P]
    lib.pack_bits.restype = I64
    lib.pack_tokens.argtypes = [P, I64, P, P, P, I64, P]
    lib.pack_tokens.restype = I64
    lib.histogram_tokens.argtypes = [P, I64, P]
    lib.histogram_tokens.restype = None


def native_packer():
    """The loaded library, built on first use; None on a host without g++
    (a failed build raises, every time it is asked for)."""
    global _lib, _no_compiler
    with _lock:
        if _lib is None and not _no_compiler:
            lib = library_path()
            if not lib.exists():
                cxx = shutil.which("g++")
                if cxx is None:
                    _no_compiler = True
                    return None
                _build(lib, cxx)
            _lib = ctypes.CDLL(str(lib))
            _bind(_lib)
        return _lib


def pack_bits(nbits: np.ndarray, values: np.ndarray) -> bytes:
    """(nbits u8, values u64 < 2^nbits, nbits <= 56) items packed LSB first
    into bytes; the last byte's unused high bits are zero."""
    lib = native_packer()
    nbits = np.ascontiguousarray(nbits, np.uint8)
    values = np.ascontiguousarray(values, np.uint64)
    if nbits.shape != values.shape:
        raise ValueError("pack_bits: nbits and values differ in shape")
    total = int(nbits.sum(dtype=np.int64))
    out = np.zeros(total // 8 + 16, np.uint8)  # 8-byte stores past the end
    got = lib.pack_bits(nbits.ctypes.data, values.ctypes.data, nbits.size, out.ctypes.data)
    if got != total:
        raise RuntimeError(f"pack_bits: packed {got} bits, expected {total}")
    return out[: (total + 7) // 8].tobytes()


def pack_tokens(stream, ctx_map, token_depths, sym_bits):
    """Entropy-code a token stream ((ctx << 16) | value words, uint32) with
    canonical prefix codes: ctx_map [contexts] u8 -> cluster;
    token_depths / sym_bits [clusters, 64] u8 / u16. Returns (bytes, bits)."""
    lib = native_packer()
    stream = np.ascontiguousarray(stream, np.uint32)
    ctx_map = np.ascontiguousarray(ctx_map, np.uint8)
    depths = np.ascontiguousarray(token_depths, np.uint8)
    bits = np.ascontiguousarray(sym_bits, np.uint16)
    if depths.shape != bits.shape or depths.shape[-1] != 64:
        raise ValueError("pack_tokens: depths and bits must be [clusters, 64]")
    ctx = stream >> 16
    if stream.size and (int(ctx.max()) >= ctx_map.size
                        or int(ctx_map[ctx].max()) >= depths.shape[0]):
        raise ValueError("pack_tokens: a context or cluster is out of range")
    out = np.zeros(stream.size * 28 // 8 + 16, np.uint8)  # <= 28 bits a token
    total = lib.pack_tokens(stream.ctypes.data, stream.size, ctx_map.ctypes.data,
                            depths.ctypes.data, bits.ctypes.data, 0, out.ctypes.data)
    return out[: (total + 7) // 8].tobytes(), int(total)


def histogram_tokens(stream, num_ctx) -> np.ndarray:
    """Counts of (ctx, token) over a token stream -> [num_ctx, 64] u32."""
    lib = native_packer()
    stream = np.ascontiguousarray(stream, np.uint32)
    if stream.size and int((stream >> 16).max()) >= num_ctx:
        raise ValueError("histogram_tokens: a context is out of range")
    hist = np.zeros((num_ctx, 64), np.uint32)
    lib.histogram_tokens(stream.ctypes.data, stream.size, hist.ctypes.data)
    return hist
