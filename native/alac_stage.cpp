// The batch decoder's padded staging: each packet's bytes as big-endian
// 32-bit words in its row of the caller's buffer, read in place from the
// packets' own buffers (the port's binding passes each `bytes` object's data
// pointer, saprobe_alac_tpu_torch/native.py), so no joined copy of the
// batch is made.
//
// The caller reuses its buffer from call to call (page-locked where a card
// reads it), so every word of it is written: a row's words past its packet
// and the rows past the last packet are zeroed, and no word of a longer
// earlier batch survives.  Every row writes the same number of words, so
// OpenMP's static schedule gives each thread an equal share.
//
// C ABI only; bound from Python via ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// Row i < count: packet i (sizes[i] bytes at ptrs[i]) as big-endian words
// (bit 31 of word 0 is its first bit), its last partial word zero-filled,
// then zeros to w_words; rows count..rows-1 all zero.  w_words must cover
// the longest packet.
void alac_pack_rows(const uint8_t* const* ptrs, const int32_t* sizes, int32_t count,
                    int32_t rows, int32_t w_words, uint32_t* out) {
#pragma omp parallel for schedule(static)
  for (int32_t i = 0; i < rows; ++i) {
    uint32_t* row = out + static_cast<int64_t>(i) * w_words;
    int32_t w = 0;
    if (i < count) {
      const uint8_t* src = ptrs[i];
      const int32_t len = sizes[i];
      const int32_t full = len / 4;
      for (; w < full; ++w) {
        const uint8_t* p = src + w * 4;
        row[w] = (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
                 (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
      }
      if (len & 3) {
        uint32_t acc = 0;
        for (int32_t b = 0; b < (len & 3); ++b)
          acc |= static_cast<uint32_t>(src[full * 4 + b]) << (24 - 8 * b);
        row[w++] = acc;
      }
    }
    std::memset(row + w, 0, static_cast<size_t>(w_words - w) * sizeof(uint32_t));
  }
}
}
