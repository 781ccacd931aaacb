"""The inputs of a run, made in set-up from the seed by the generator that
the configuration names (`"generator"`: benchmark/generators/<name>.py),
and the helpers generators share.

A generator module defines `Pool(root, config, traffic, seed)`, whose
object holds
  requests             a list of requests, each a list of [3, H, W] images
                       (one for a single encode or a stream, `batch` tiles
                       for a batch call);
  order()              an endless iterator of pool indices, the requests
                       in the order they are sent;
  reference_pixels(im) the float32 linear pixels the encoder works on, as
                       the configuration states them;
  upload               the upload type the traffic mix states, or None.
Every seed gets the same work (sizes, mix and bytes), other pixels and
another order.
"""
import numpy as np

from . import spec

ORIENT = {
    "none": lambda a: a,
    "flip_x": lambda a: a[:, :, ::-1],
    "flip_y": lambda a: a[:, ::-1, :],
    "rot180": lambda a: a[:, ::-1, ::-1],
}


def make_pool(root, config, traffic, seed, bench_dir=spec.BENCH_DIR):
    """The pool of one run, from the generator the configuration names."""
    gen = spec.load_module("generators", config["generator"], bench_dir)
    return gen.Pool(root, config, traffic, seed)


def rng_for(seed, stream):
    """A generator for one use of the seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def sample(keys, seed, n):
    """The n of the sorted keys that a run of this seed compares with the
    reference (the control reads the same)."""
    keys = sorted(keys)
    return [keys[j] for j in rng_for(seed, 4).permutation(len(keys))[:n]]


def read_pfm(path) -> np.ndarray:
    """A colour PFM file -> [3, H, W] float32 linear, top row first."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos: pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end: end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end + 1
    if fields[0] != b"PF":
        raise ValueError(f"{path}: not a colour PFM file")
    w, h, scale = int(fields[1]), int(fields[2]), float(fields[3])
    img = np.frombuffer(data, "<f4" if scale < 0 else ">f4", count=w * h * 3, offset=pos)
    return np.ascontiguousarray(img.reshape(h, w, 3)[::-1].transpose(2, 0, 1)).astype(np.float32)


