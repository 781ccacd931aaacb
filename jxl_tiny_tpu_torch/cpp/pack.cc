// Host-side native packer: the serial bitstream stages of the encoder (the
// port's own copy of the JAX package's cpp/pack.cc).
//
// The equivalent of the reference's C++ bit writer fast path
// (encoder/enc_bit_writer.cc:119-142 semantics: LSB-first, little-endian
// unaligned 64-bit stores). Python orchestrates; these loops are the only
// host code with per-item work. BitWriter.to_bytes calls pack_bits;
// pack_tokens and histogram_tokens entropy-code and count a host token
// stream.
//
// Build: g++ -O2 -shared -fPIC (build.py, at first use, into a directory
// keyed by a hash of this source and the flags).

#include <cstdint>
#include <cstring>

extern "C" {

// Pack (nbits[i], bits[i]) items LSB-first into out. out must have at least
// (sum(nbits)+7)/8 + 8 bytes and be zero-initialized. Returns total bits.
int64_t pack_bits(const uint8_t* nbits, const uint64_t* bits, int64_t n,
                  uint8_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const unsigned nb = nbits[i];
    if (nb == 0) continue;
    uint8_t* p = out + (pos >> 3);
    uint64_t v;
    std::memcpy(&v, p, 8);
    v |= bits[i] << (pos & 7);
    std::memcpy(p, &v, 8);
    pos += nb;
  }
  return pos;
}

// Entropy-code one token stream: items are (ctx<<16)|value words in emission
// order. ctx_map maps context id -> cluster; depths/sym_bits are [clusters*64]
// canonical prefix code tables; token_depths has single-symbol clusters
// zeroed (0-bit codes). Appends at bit position `pos` in out (zeroed, sized
// for worst case 28 bits/token). Returns new bit position.
int64_t pack_tokens(const uint32_t* stream, int64_t n, const uint8_t* ctx_map,
                    const uint8_t* token_depths, const uint16_t* sym_bits,
                    int64_t pos, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t w = stream[i];
    const uint32_t value = w & 0xFFFF;
    const uint32_t ctx = w >> 16;
    // Hybrid uint split (token.h:24-48): <16 direct, else (n<<2)|(msb 2 bits)
    // plus n-2 raw bits.
    uint32_t tok, nb2, extra;
    if (value < 16) {
      tok = value;
      nb2 = 0;
      extra = 0;
    } else {
      const uint32_t nlog = 31 - __builtin_clz(value);
      tok = (nlog << 2) + ((value >> (nlog - 2)) & 3);
      nb2 = nlog - 2;
      extra = value & ((1u << nb2) - 1);
    }
    const uint32_t cluster = ctx_map[ctx];
    const uint32_t d = token_depths[cluster * 64 + tok];
    const uint64_t data =
        static_cast<uint64_t>(sym_bits[cluster * 64 + tok]) |
        (static_cast<uint64_t>(extra) << d);
    uint8_t* p = out + (pos >> 3);
    uint64_t v;
    std::memcpy(&v, p, 8);
    v |= data << (pos & 7);
    std::memcpy(p, &v, 8);
    pos += d + nb2;
  }
  return pos;
}

// Histogram a token stream into hist[num_ctx*64] (uint32 counts).
void histogram_tokens(const uint32_t* stream, int64_t n, uint32_t* hist) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t w = stream[i];
    const uint32_t value = w & 0xFFFF;
    const uint32_t ctx = w >> 16;
    uint32_t tok;
    if (value < 16) {
      tok = value;
    } else {
      const uint32_t nlog = 31 - __builtin_clz(value);
      tok = (nlog << 2) + ((value >> (nlog - 2)) & 3);
    }
    ++hist[ctx * 64 + tok];
  }
}

}  // extern "C"
