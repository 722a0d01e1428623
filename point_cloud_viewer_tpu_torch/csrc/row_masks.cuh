// Bit masks over a lane's 32 consecutive u8 rows, shared by the K6 leaf
// stage (leaf_levels.cu) and the K4 promotion (promote.cu).
//
// A lane holds its rows as eight 32-bit words, four rows a word: row
// 4q + k is byte k of word q.  A test of each byte against one level gives
// one bit a row, row k in bit k, without a loop over the rows.
#pragma once

#include <cstdint>

namespace pcv {
namespace {

constexpr unsigned kFull = 0xffffffffu;

// Bits 4q..4q+3 from bits 0, 8, 16, 24 of word q (0 or 1 in each byte).
__device__ __forceinline__ unsigned gather_bytes(const unsigned (&ones)[8]) {
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // The four bytes' bits 0, 8, 16, 24 gathered into bits 24-27 by one
    // multiply (the partial products never overlap, so nothing carries).
    m |= ((ones[q] * 0x01020408u) >> 24) << (4 * q);
  }
  return m;
}

// Bit k set iff row k of the lane starts a segment at `level`: b <= level.
// Bytes hold b <= 0x7F (rows past n: 0x7F, never a start) and level <=
// 0x7E, so adding 0x7F - level to each byte carries into no other byte,
// and a byte's top bit stays clear exactly where b <= level.
__device__ __forceinline__ unsigned start_mask(const unsigned (&bw)[8],
                                               int level) {
  const unsigned add = static_cast<unsigned>(0x7F - level) * 0x01010101u;
  unsigned ones[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) ones[q] = (~(bw[q] + add) & 0x80808080u) >> 7;
  return gather_bytes(ones);
}

// start_mask of the 32 bytes of b at p (shared memory, 16-B aligned).
__device__ __forceinline__ unsigned lane_mask(const uint8_t* p, int level) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 c = *reinterpret_cast<const uint4*>(p + 16);
  const unsigned bw[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  return start_mask(bw, level);
}

// Bit k set iff row k's byte equals `value` (any bytes, value < 256).
__device__ __forceinline__ unsigned equal_mask(const unsigned (&w)[8],
                                               int value) {
  const unsigned v = static_cast<unsigned>(value) * 0x01010101u;
  unsigned ones[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned x = w[q] ^ v;
    // A byte of x is 0 iff neither its top bit nor, after adding 0x7F to
    // its low seven bits (at most 0xFE: no carry out), bit 7 is set.
    ones[q] = (~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u) >> 7;
  }
  return gather_bytes(ones);
}

// Bytes of the eight words whose row bit is set in `rows` become `value`.
__device__ __forceinline__ void set_bytes(unsigned (&w)[8], unsigned rows,
                                          int value) {
  const unsigned v = static_cast<unsigned>(value) * 0x01010101u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // Rows 4q..4q+3 of `rows` spread to one 0xFF byte each.
    const unsigned nib = (rows >> (4 * q)) & 0xFu;
    const unsigned bm = ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
    w[q] = (w[q] & ~bm) | (v & bm);
  }
}

}  // namespace
}  // namespace pcv
