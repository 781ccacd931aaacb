"""LSB-first bit reader (mirror of the writer; used by the verification
decoder). Strict: consuming bits past the end of the buffer raises
DecodeError (peek alone tolerates the zero-padded tail — prefix-code
lookahead windows may legitimately cross the final byte).

Frozen copy for the benchmark of jxl_tiny_tpu_torch/bitstream/bit_reader.py
at commit 8ebce9c.
"""
import numpy as np

from .errors import DecodeError


class BitReader:
    def __init__(self, data: bytes):
        self._data = np.frombuffer(data, np.uint8)
        # 64-bit little-endian words for fast multi-bit reads.
        pad = (-len(data)) % 8 + 8
        padded = np.concatenate([self._data, np.zeros(pad, np.uint8)])
        self._words = padded.view("<u8")
        self._pos = 0  # bit position
        self._total_bits = 8 * len(data)

    @property
    def pos(self) -> int:
        return self._pos

    def bits_remaining(self) -> int:
        return self._total_bits - self._pos

    def _peek_at(self, pos: int, nbits: int) -> int:
        word_idx = pos >> 6
        bit_off = pos & 63
        lo = int(self._words[word_idx]) >> bit_off
        if bit_off + nbits > 64:
            lo |= int(self._words[word_idx + 1]) << (64 - bit_off)
        return lo & ((1 << nbits) - 1)

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        assert nbits <= 56
        if self._pos + nbits > self._total_bits:
            raise DecodeError(
                f"read past end of stream (pos {self._pos} + {nbits} "
                f"> {self._total_bits})"
            )
        v = self._peek_at(self._pos, nbits)
        self._pos += nbits
        return v

    def peek(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        assert nbits <= 56
        return self._peek_at(self._pos, nbits)

    def skip(self, nbits: int):
        if self._pos + nbits > self._total_bits:
            raise DecodeError("skip past end of stream")
        self._pos += nbits

    def zero_pad_to_byte(self):
        rem = (-self._pos) % 8
        if rem:
            v = self.read(rem)
            if v != 0:
                raise DecodeError("nonzero padding bits")
