"""The encoder's device and its host <-> card transfers, none of which waits
for queued work: the pixel upload, the copies of results to the host, and
the read of several results at once (on a mesh: gathered to rank 0).

Below the encoder and parallel/ alike, which both import it."""
import functools

import numpy as np
import torch

from .tables import canonical_device

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; without one, raise rather than fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain torch "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def side_stream(device, purpose):
    """One stream a card for each purpose ("upload", "fetch")."""
    return torch.cuda.Stream(device)


def upload_pixels(imgs, dtype, device) -> torch.Tensor:
    """Host pixels -> a tensor of `dtype` on `device`: one [3, H, W] array,
    or a list of same-shaped ones as [N, 3, H, W].

    On the card each image is converted straight into one pinned buffer
    (no stacked copy on the host), whose copy runs on the upload stream;
    the compute stream waits for the copy's event, and the tensor is
    recorded on the compute stream so that the caching allocator does not
    reuse it while work queued there may still read it."""
    batch = isinstance(imgs, list)
    if device.type != "cuda":
        arr = np.stack(imgs) if batch else imgs
        return torch.from_numpy(np.ascontiguousarray(arr.astype(dtype)))
    shape = (len(imgs),) + imgs[0].shape if batch else imgs.shape
    host = torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)], pin_memory=True)
    dst = host.numpy()
    for k, img in enumerate(imgs if batch else [imgs]):
        np.copyto(dst[k] if batch else dst, img, casting="same_kind")
    upload = side_stream(canonical_device(device), "upload")
    with torch.cuda.stream(upload):
        up = host.to(device, non_blocking=True)
    compute = torch.cuda.current_stream(device)
    compute.wait_stream(upload)
    up.record_stream(compute)
    return up


class Fetch:
    """A device tensor's copy to the host, queued at once and waited for
    only when read. On the card it goes into pinned memory on the fetch
    stream, after the event `after` of the compute stream (default: one
    recorded now, so the copy waits for the work queued so far and not for
    work queued later); `ready()` polls the copy's event. On the CPU it is
    the tensor itself."""

    def __init__(self, t, after=None):
        self._event = self.after = None
        if not t.is_cuda:
            self._host = t
            return
        if after is None:
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(t.device))
        self.after = after
        fetch = side_stream(canonical_device(t.device), "fetch")
        fetch.wait_event(after)
        with torch.cuda.stream(fetch):
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
        t.record_stream(fetch)
        self._event = torch.cuda.Event()
        self._event.record(fetch)

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def host_arrays(out):
    """A dict of device results -> host arrays, waiting for each: token
    words ("stream", "tokens": int32 on the device) as uint32, the rest in
    their own types."""
    host = {}
    for k, v in out.items():
        a = v.cpu().numpy()
        host[k] = a.view(np.uint32) if k in ("stream", "tokens") else a
    return host


def read_parts(parts, after=None, mesh=None):
    """Device tensors -> host arrays with a leading rank axis ([1, ...]
    without a mesh), all copies queued before any is waited for. With a
    mesh (parallel.sharding.Mesh; each part one shape on every rank):
    every rank's parts gathered to rank 0 as one flat tensor (one
    collective, one copy to the host); None on the other ranks."""
    if mesh is None:
        fetches = [Fetch(p, after) for p in parts]
        return [f.numpy()[None] for f in fetches]
    flat = mesh.gather0(torch.cat([p.reshape(-1) for p in parts]))
    if flat is None:
        return None
    rows = Fetch(flat).numpy()
    ends = np.cumsum([0] + [p.numel() for p in parts])
    return [rows[:, a:b].reshape((mesh.size,) + tuple(p.shape))
            for a, b, p in zip(ends[:-1], ends[1:], parts)]
