"""A pool of panoramas stitched from one photograph (BASELINE.json config 5):
the photograph in each of its orientations at each exposure gain, set over
its vertical flip, that beside its horizontal flip, that over its vertical
flip, and cut to the configured `panorama` size (8192x7680 from the
3840x2160 photo8mp).

The seed moves each gain as photo_variants does and picks the order of the
requests; the sizes, the mix and the bytes a run encodes stay the same
from seed to seed. The pool keeps what made it (`source`), so that each
rank of a mesh makes the same pool itself.
"""
import os

import numpy as np

from jxlbench import spec
from jxlbench.inputs import ORIENT, read_pfm, rng_for

_photos = spec.load_module("generators", "photo_variants")


def panorama(img, h, w):
    """The image over its vertical flip, that beside its horizontal flip,
    that over its vertical flip, cut to [:, :h, :w]."""
    pan = np.concatenate([img, img[:, ::-1]], axis=1)
    pan = np.concatenate([pan, pan[:, :, ::-1]], axis=2)
    pan = np.concatenate([pan, pan[:, ::-1]], axis=1)
    if pan.shape[1] < h or pan.shape[2] < w:
        raise ValueError(f"a {img.shape[1]}x{img.shape[2]} image makes no {h}x{w} panorama")
    return np.ascontiguousarray(pan[:, :h, :w])


class Pool(_photos.Pool):
    """photo_variants' requests, order and reference pixels, each image a
    panorama of one orientation of the photograph at one gain."""

    def __init__(self, root, config, traffic, seed):
        self.source = dict(root=root, config=config, traffic=traffic, seed=int(seed))
        self.pixels = traffic["pixels"]
        self.upload = traffic.get("upload")
        base = read_pfm(os.path.join(root, config["image"]))
        if base.shape != (3, config["height"], config["width"]):
            raise ValueError(f"{config['image']}: shape {base.shape}, config says "
                             f"{config['width']}x{config['height']}")
        var = config["variants"]
        jitter = rng_for(seed, 1).uniform(-1.0, 1.0, len(var["gains"]))
        self.gains = [g * (1.0 + var["gain_jitter"] * j) for g, j in zip(var["gains"], jitter)]
        h, w = config["panorama"]
        orients = var["orientations"]
        self.requests = []
        for g in self.gains:
            scene = self._convert(base * np.float32(g))
            self.requests += [[panorama(ORIENT[o](scene), h, w)] for o in orients]
        self._groups = [list(range(k * len(orients), (k + 1) * len(orients)))
                        for k in range(len(self.gains))]
        self._order_rng = rng_for(seed, 3)
