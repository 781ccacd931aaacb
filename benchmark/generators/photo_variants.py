"""A pool of photographs from one image file: the configured image in its
orientations at its exposure gains, whole or cut into tiles.

The configuration fixes the photograph, its orientations, its exposure
gains and, for tiles, the crop positions. The seed moves each gain by a
small jitter (so that no two seeds send the same pixels) and picks the
order of the requests and of the tiles in a batch. So the sizes, the mix
and the bytes a run encodes stay the same from seed to seed, and only the
pixels and the order change.
"""
import os

import numpy as np

from jxlbench.inputs import ORIENT, read_pfm, rng_for
from jxlbench.reference.golden import linear_to_srgb_u8, srgb_u8_to_linear_table


class Pool:
    """The requests of one run: `requests[i]` is a list of images, `order`
    yields the pool index of each request sent, and `reference_pixels`
    gives an image as the configuration says the encoder sees it."""

    def __init__(self, root, config, traffic, seed):
        self.pixels = traffic["pixels"]
        self.upload = traffic.get("upload")
        base = read_pfm(os.path.join(root, config["image"]))
        if base.shape != (3, config["height"], config["width"]):
            raise ValueError(f"{config['image']}: shape {base.shape}, config says "
                             f"{config['width']}x{config['height']}")
        var = config["variants"]
        jitter = rng_for(seed, 1).uniform(-1.0, 1.0, len(var["gains"]))
        gains = [g * (1.0 + var["gain_jitter"] * j) for g, j in zip(var["gains"], jitter)]
        self.gains = gains
        scenes = [self._convert(base * np.float32(g)) for g in gains]
        shuffle = rng_for(seed, 2)
        if config.get("tile"):
            # Batch b takes orientation o's tiles from scene (o + b) mod the
            # scenes: every batch holds each gain's share of the tiles.
            self.requests = [self._tiles(scenes, b, config, traffic, shuffle)
                             for b in range(len(scenes))]
            self._groups = [[b] for b in range(len(scenes))]
        else:
            orients = var["orientations"]
            self.requests = [[np.ascontiguousarray(ORIENT[o](s))] for s in scenes for o in orients]
            self._groups = [list(range(k * len(orients), (k + 1) * len(orients)))
                            for k in range(len(scenes))]
        self._order_rng = rng_for(seed, 3)

    def _convert(self, lin):
        if self.pixels == "u8":
            return linear_to_srgb_u8(lin)
        if self.pixels == "f32":
            return np.ascontiguousarray(lin, np.float32)
        raise ValueError(f"unknown pixel type {self.pixels}")

    @staticmethod
    def _tiles(scenes, b, config, traffic, rng):
        th, tw = config["tile"]
        orients = config["variants"]["orientations"]
        places = [(i, y, x) for i in range(len(orients))
                  for y in config["tile_rows"] for x in config["tile_cols"]]
        n = traffic.get("batch", 1)
        pick = [places[k % len(places)] for k in rng.permutation(max(n, len(places)))[:n]]
        return [np.ascontiguousarray(
                    ORIENT[orients[i]](scenes[(i + b) % len(scenes)])[:, y: y + th, x: x + tw])
                for i, y, x in pick]

    def order(self):
        """Pool indices, forever, in rounds: each round takes every request
        once, the scenes (gains) in turn, each scene's requests in a fresh
        order; so any stretch of the run holds the gains in equal shares,
        and the same request never comes twice in a row."""
        last = None
        while True:
            perms = [list(self._order_rng.permutation(g)) for g in self._groups]
            turn = list(self._order_rng.permutation(len(perms)))
            if len(turn) > 1 and perms[turn[0]][0] == last:
                turn = turn[1:] + turn[:1]
            rnd = [int(p[k]) for k in range(max(map(len, perms))) for j in turn
                   for p in [perms[j]] if k < len(p)]
            if len(rnd) > 1 and rnd[0] == last:
                rnd[0], rnd[1] = rnd[1], rnd[0]
            yield from rnd
            last = rnd[-1]

    def reference_pixels(self, img) -> np.ndarray:
        """The float32 linear pixels the encoder works on, as the
        configuration states them: 8-bit sRGB through the IEC 61966-2-1
        EOTF; float through the stated upload type."""
        if img.dtype == np.uint8:
            return srgb_u8_to_linear_table()[img]
        if self.upload == "float16":
            return img.astype(np.float16).astype(np.float32)
        return np.asarray(img, np.float32)
