"""LSB-first bit writer.

Same bit order as the reference's BitWriter (encoder/enc_bit_writer.cc:110-142):
the first bit written lands in the LSB of the first byte.

Values are buffered as (nbits, value) arrays and packed at the end, by the
native packer (cpp/pack.cc) or, on a host without g++, by numpy.
"""
import numpy as np

from ..cpp.build import native_packer, pack_bits


class BitWriter:
    def __init__(self):
        self._chunks = []  # list of (nbits u8 array, values u64 array)
        self._bits_written = 0

    @property
    def bits_written(self) -> int:
        return self._bits_written

    def write(self, nbits: int, value: int):
        assert 0 <= nbits <= 56
        assert value >> nbits == 0, (nbits, value)
        if nbits == 0:
            return
        self._chunks.append(
            (np.array([nbits], np.uint8), np.array([value], np.uint64))
        )
        self._bits_written += nbits

    def write_arrays(self, nbits: np.ndarray, values: np.ndarray):
        """Append many (nbits, value) items at once. Zero-length items allowed."""
        nbits = np.asarray(nbits, np.uint8)
        values = np.asarray(values, np.uint64)
        assert nbits.shape == values.shape
        if nbits.size == 0:
            return
        self._chunks.append((nbits.ravel(), values.ravel()))
        self._bits_written += int(nbits.sum(dtype=np.int64))

    def zero_pad_to_byte(self):
        rem = (-self._bits_written) % 8
        if rem:
            self.write(rem, 0)

    def append_writer(self, other: "BitWriter"):
        """Bit-level concatenation (reference BitWriter::Append)."""
        for nb, v in other._chunks:
            self._chunks.append((nb, v))
        self._bits_written += other._bits_written

    @classmethod
    def from_packed(cls, raw: np.ndarray, nbits: int) -> "BitWriter":
        """A writer holding `nbits` bits whose byte image is `raw` (u8, LSB
        first); bits of the last partial byte past `nbits` are dropped."""
        w = cls()
        full = nbits // 8
        if full:
            w.write_arrays(np.full(full, 8, np.uint8), raw[:full].astype(np.uint64))
        rem = nbits & 7
        if rem:
            w.write(rem, int(raw[full]) & ((1 << rem) - 1))
        return w

    def append_bytes_aligned(self, raw: bytes):
        """Byte-aligned append of pre-packed bytes."""
        assert self._bits_written % 8 == 0
        arr = np.frombuffer(raw, np.uint8)
        self._chunks.append((np.full(arr.shape, 8, np.uint8), arr.astype(np.uint64)))
        self._bits_written += 8 * len(raw)

    def to_bytes(self) -> bytes:
        """The bits written so far, packed LSB first; with the native packer
        (cpp/) where g++ could build it, else with numpy (the same bytes)."""
        if not self._chunks:
            return b""
        nbits = np.concatenate([c[0] for c in self._chunks])
        values = np.concatenate([c[1] for c in self._chunks])
        assert int(nbits.sum(dtype=np.int64)) == self._bits_written
        if native_packer() is not None:
            return pack_bits(nbits, values)
        return pack_bits_numpy(nbits, values)


def pack_bits_numpy(nbits: np.ndarray, values: np.ndarray) -> bytes:
    """numpy twin of the native pack_bits: (nbits u8 <= 56, values u64)
    items packed LSB first."""
    nbits = nbits.astype(np.int64)
    pos = np.zeros(nbits.size, np.int64)
    np.cumsum(nbits[:-1], out=pos[1:])
    total_bits = int(pos[-1] + nbits[-1]) if nbits.size else 0
    nbytes = (total_bits + 7) // 8
    byte0 = pos >> 3
    shift = (pos & 7).astype(np.uint64)
    shifted = values.astype(np.uint64) << shift  # fits: <=56 bits value + 7 shift < 64
    # Items never share a bit, so summing each byte's contributions ORs
    # them; bincount's float64 sums are exact for these small integers.
    acc = np.zeros(nbytes + 8, np.float64)
    for k in range(8):
        lane = (shifted >> np.uint64(8 * k)) & np.uint64(0xFF)
        nz = lane != 0
        if np.any(nz):
            acc += np.bincount(
                byte0[nz] + k, weights=lane[nz].astype(np.float64),
                minlength=nbytes + 8,
            )
    return acc[:nbytes].astype(np.uint8).tobytes()
