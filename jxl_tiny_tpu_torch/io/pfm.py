"""PFM (portable float map) reader and writer.

Functional equivalent of the reference's minimal parser
(encoder/read_pfm.cc:24-213): 'PF' color images only, scale sign selects
endianness, rows are stored bottom-up. Returns planar [3, H, W] float32.
"""
import numpy as np

from ..errors import InvalidInputError


def read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()

    def _token(pos):
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        return data[start:pos], pos + 1  # consume single whitespace after token

    magic, pos = _token(0)
    if magic != b"PF":
        raise InvalidInputError(f"not a color PFM file: magic={magic!r}")
    w_s, pos = _token(pos)
    h_s, pos = _token(pos)
    scale_s, pos = _token(pos)
    w, h, scale = int(w_s), int(h_s), float(scale_s)
    dtype = "<f4" if scale < 0 else ">f4"
    img = np.frombuffer(data, dtype=dtype, count=w * h * 3, offset=pos)
    img = img.reshape(h, w, 3)[::-1]  # bottom-up -> top-down
    return np.ascontiguousarray(img.transpose(2, 0, 1)).astype(np.float32)


def write_pfm(path, img: np.ndarray):
    """img: [3, H, W] float32, linear sRGB."""
    if img.ndim != 3 or img.shape[0] != 3:
        raise InvalidInputError(f"expected a [3, H, W] image, got {img.shape}")
    h, w = img.shape[1], img.shape[2]
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(img.transpose(1, 2, 0)[::-1].astype("<f4").tobytes())
