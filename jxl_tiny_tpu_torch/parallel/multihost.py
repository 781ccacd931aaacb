"""Multi-process scale-out: the process group, the global mesh, the gather
of the section words to rank 0 and the encode over it.

Counterpart of the JAX package's parallel/multihost.py. Every rank is one
process with one device and calls the same functions on the same image;
the device programs are DeviceEncodeJob's mesh mode (parallel.sharding),
whose only collectives are the integer histogram sums, the gathers of
the per-group maps and the small section sizes, and the gather of the
section words to rank 0, which assembles the codestream.

Start the ranks with torchrun (env://) or a launcher of your own that
calls initialize() in every process (tools/multihost_dryrun.py).
"""
import datetime
from urllib.parse import urlparse

import torch
import torch.distributed as dist

from ..encoder import encode_image_device_mesh
from ..transfer import read_parts, resolve_device
from .sharding import make_mesh

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def initialize(init_method: str, world_size: int, rank: int, device=None,
               backend=None, timeout_s: float = 60.0):
    """init_process_group for this rank. init_method: file://<path>,
    tcp://127.0.0.1:<port> (loopback only) or env:// (torchrun's
    MASTER_ADDR / MASTER_PORT). device: None for this rank's CUDA card
    (raises without one, before any group comes up), or e.g. "cpu" for a
    group of CPU ranks. backend: None for NCCL on a CUDA device and gloo on
    the CPU; ranks that share one card pass "gloo". Every collective of the
    group fails after timeout_s (at most 60 s) instead of waiting for a
    rank that is gone."""
    url = urlparse(init_method)
    if url.scheme == "tcp" and url.hostname not in _LOOPBACK:
        raise ValueError(f"{init_method}: only a loopback address is allowed")
    if url.scheme not in ("tcp", "file", "env"):
        raise ValueError(f"{init_method}: expected file://, tcp:// or env://")
    if timeout_s > 60:
        raise ValueError("the group's timeout is at most 60 s")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def global_mesh(device=None):
    """The mesh over every rank of the initialized process group, in rank
    order; device as parallel.sharding.make_mesh."""
    return make_mesh(device)


def host0_gather(tensors, mesh):
    """Every rank's device tensors (each one shape on every rank) -> on
    rank 0, host arrays with a leading rank axis [size, ...]; None on the
    other ranks. One gather of the flattened tensors to rank 0, one copy
    to the host there."""
    return read_parts(list(tensors), mesh=mesh)


def encode_image_multihost(img, distance=1.0, config=None, cap=32768, ow=8192,
                           device=None, dc_exchange="gather"):
    """The full encode over the global mesh, float pixels uploaded as
    float32 (the JAX package's choice here): every rank runs its part of
    the device programs, rank 0 assembles and returns the codestream (the
    other ranks return None)."""
    return encode_image_device_mesh(img, distance, global_mesh(device), cap, ow,
                                    upload_dtype=None, config=config,
                                    dc_exchange=dc_exchange)
