// The decode half of an order-0 rANS-4x8 kernel run by one warp per stream,
// shared by csrc/rans_simd.cu (B3) and csrc/rans.cu (B5), which compute the
// same function and differ only in how they build a stream's slot table.
// Given that table -- 4096 packed entries {freq[sym], (slot - cum[sym]) |
// sym << 24} in shared memory -- decode_stream decodes one stream from its
// renorm bytes: a 4 KiB ring in shared memory filled by cp.async one half
// ahead, zero at and past clen; the four states of a superstep decoded
// together from one 8-byte window; output in aligned 32-bit words stitched
// across the stream's misalignment. The design and what bounds it are set
// out in csrc/rans_simd.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RANS_LOW (1u << 23)
#define TOTFREQ 4096
#define RING 4096                  // renorm-byte ring per stream, bytes
#define HALF (RING / 2)
#define RING_WORDS (RING / 8)
#define GROUP 8                   // supersteps per ring check
#define MARGIN (16 + 8 * (GROUP - 1))  // bytes a group may read past P

__device__ __forceinline__ void ring_fill(uint8_t* ring, uintptr_t a0,
                                          uintptr_t end, int64_t lin,
                                          int lane) {
  // bytes [a0 + lin, a0 + lin + HALF) of the blob into the ring half that
  // holds them; bytes at or past `end` (the stream's clen) become 0
  for (int c = lane; c < HALF / 16; c += 32) {
    uintptr_t addr = a0 + (uintptr_t)lin + 16u * c;
    uint8_t* dst = ring + ((lin + 16 * c) & (RING - 1));
    int64_t avail = (int64_t)end - (int64_t)addr;
    if (avail > 0) {
      unsigned nb = avail < 16 ? (unsigned)avail : 16u;
      unsigned s = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(addr), "r"(nb));
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// The renorm ring's refill schedule: every read of the next GROUP
// supersteps (at most P + MARGIN) lies in bytes that have arrived, and a
// half is refilled once the decoder has passed it.
struct Ring {
  uint8_t* buf;
  uintptr_t a0, end;
  int64_t issued;    // linear end of the bytes issued to the ring
  int64_t trigger;   // the next P + MARGIN at which to look again
  bool pending;      // a half is still in flight
  int lane;

  __device__ __forceinline__ void keep(int64_t P) {
    if (P + MARGIN > trigger) {  // rare: a few times per 2 KiB of input
      if (pending && P + MARGIN > issued - HALF) {
        ring_wait();
        pending = false;
      }
      if (!pending && (P & ~(int64_t)7) >= issued - HALF) {
        ring_fill(buf, a0, end, issued, lane);
        issued += HALF;
        pending = true;
      }
      trigger = pending ? issued - HALF : issued - HALF + MARGIN - 1;
    }
  }
};

// One superstep: the four states' symbols (as one little-endian word) and
// their renormalization from the 8 bytes at the read offset P. In the last,
// partial superstep only states below `live` renormalize.
template <bool FULL>
__device__ __forceinline__ uint32_t superstep(uint32_t (&x)[4], int64_t& P,
                                              const uint2* tab,
                                              const uint64_t* ring64,
                                              int live = 4) {
  const uint32_t q = (uint32_t)P >> 3;
  const uint64_t w0 = ring64[q & (RING_WORDS - 1)];
  const uint64_t w1 = ring64[(q + 1) & (RING_WORDS - 1)];
  const uint32_t sh = ((uint32_t)P & 7) * 8;
  // bits shifted in from w1 are zero when sh == 0
  const uint64_t w = (w0 >> sh) | ((w1 << 1) << (63 - sh));
  const uint32_t lo = (uint32_t)w, hi = (uint32_t)(w >> 32);
  uint32_t n[4], word = 0, c[4];
  bool lt23[4], lt15[4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const uint2 e = tab[x[j] & (TOTFREQ - 1)];
    n[j] = e.x * (x[j] >> 12) + (e.y & 0xFFFFFFu);
    word |= (e.y >> 24) << (8 * j);
    lt23[j] = n[j] < RANS_LOW && (FULL || j < live);
    lt15[j] = n[j] < (RANS_LOW >> 8) && (FULL || j < live);
    c[j] = (uint32_t)lt23[j] + (uint32_t)lt15[j];
  }
  uint32_t p = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    // bytes p and p+1 of the window, then (n << 8c) | those c bytes
    const uint32_t v = __byte_perm(lo, hi, p | (p + 1) << 4);
    const uint32_t sel = lt15[j] ? 0x1045u : lt23[j] ? 0x2104u : 0x3210u;
    x[j] = __byte_perm(n[j], v, sel);
    p += c[j];
  }
  P += p;
  return word;
}

// Decode one stream on the calling warp: `raw` output bytes to `o` from the
// renorm bytes body[0, clen) and the initial states x0[0..3], through the
// slot table `tab` (written by the warp and not yet ordered before the
// decode: the first ring_wait orders it) and the 4 KiB shared-memory ring
// `ring_buf` (16-byte aligned). Lane 0 writes *used and *status.
__device__ __forceinline__ void decode_stream(
    const uint2* tab, uint8_t* ring_buf, const uint8_t* body, int64_t clen,
    uint8_t* o, int64_t raw, const int32_t* x0, int lane, int64_t* used,
    int32_t* status) {
  // -- the renorm ring: linear position P = byte offset from a0 -----------
  Ring ring;
  ring.buf = ring_buf;
  ring.a0 = (uintptr_t)body & ~(uintptr_t)15;
  ring.end = (uintptr_t)body + (uintptr_t)clen;
  ring.lane = lane;
  const int64_t head = (int64_t)((uintptr_t)body - ring.a0);
  ring_fill(ring_buf, ring.a0, ring.end, 0, lane);
  ring_fill(ring_buf, ring.a0, ring.end, HALF, lane);
  ring_wait();  // also orders the table writes before the decode
  ring.issued = RING;
  ring.pending = false;
  ring.trigger = HALF + MARGIN - 1;
  const uint64_t* ring64 = reinterpret_cast<const uint64_t*>(ring_buf);

  // -- the decode: output in aligned words, stitched across the stream's
  // misalignment a; the head and tail bytes are stored singly ------------
  const int64_t full = raw >> 2;
  const uint32_t a = (uint32_t)((uintptr_t)o & 3);
  uint32_t* ow = reinterpret_cast<uint32_t*>(o - a);  // aligned words
  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; j++) x[j] = (uint32_t)x0[j];
  int64_t P = head;  // the read offset's linear position: used = P - head
  uint32_t prev = 0;
  if (full > 0) {
    ring.keep(P);
    prev = superstep<true>(x, P, tab, ring64);
    if (lane == 0)
      for (uint32_t j = 0; j < 4 - a; j++) o[j] = (uint8_t)(prev >> (8 * j));
  }
  int64_t k = 1;
  for (; k + GROUP <= full; k += GROUP) {
    ring.keep(P);
#pragma unroll
    for (int j = 0; j < GROUP; j++) {
      const uint32_t word = superstep<true>(x, P, tab, ring64);
      // the previous superstep's last a bytes and this one's first 4 - a
      if (lane == 0) ow[k + j] = __funnelshift_l(prev, word, 8 * a);
      prev = word;
    }
  }
  for (; k < full; k++) {
    ring.keep(P);
    const uint32_t word = superstep<true>(x, P, tab, ring64);
    if (lane == 0) ow[k] = __funnelshift_l(prev, word, 8 * a);
    prev = word;
  }
  if (lane == 0 && full > 0)
    for (uint32_t j = 0; j < a; j++)
      o[4 * full - a + j] = (uint8_t)(prev >> (8 * (4 - a + j)));
  const int rem = (int)(raw & 3);
  if (rem) {
    ring.keep(P);
    const uint32_t word = superstep<false>(x, P, tab, ring64, rem);
    if (lane == 0)
      for (int j = 0; j < rem; j++) o[4 * full + j] = (uint8_t)(word >> (8 * j));
  }
  ring_wait();  // no refill may land in shared memory after the block exits
  if (lane == 0) {
    *used = P - head;
    *status = P - head > clen ? 6 : 0;
  }
}
