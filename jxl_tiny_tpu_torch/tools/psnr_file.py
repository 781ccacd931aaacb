"""PSNR of encoded .jxl files against their source .pfm files, through the
port's verification decoder (jxl_tiny_tpu_torch.decode).

    python -m jxl_tiny_tpu_torch.tools.psnr_file out.jxl source.pfm [more.jxl source.pfm ...]

Prints one line a pair: `<jxl>: psnr=<dB>` (3 decimals). Decoding is numpy
on the host: about 40 s for an 8 MP image, minutes for the 63 MP panorama of
BASELINE.md's config 5. Counterpart of the JAX package's
tools/psnr_file.py, with the same PSNR (both images clipped to [0, 1]).
"""
import sys

import numpy as np


def psnr(a, b):
    """PSNR (dB) of two linear images, each clipped to [0, 1]."""
    mse = float(((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2).mean())
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def psnr_pair(jxl_path, pfm_path):
    from ..decode import decode_jxl
    from ..io.pfm import read_pfm

    with open(jxl_path, "rb") as f:
        data = f.read()
    return psnr(decode_jxl(data), read_pfm(pfm_path))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) % 2:
        print("usage: python -m jxl_tiny_tpu_torch.tools.psnr_file out.jxl source.pfm "
              "[more.jxl source.pfm ...]", file=sys.stderr)
        return 2
    for jxl_path, pfm_path in zip(argv[::2], argv[1::2]):
        print(f"{jxl_path}: psnr={psnr_pair(jxl_path, pfm_path):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
