// rANS-4x8 order-0 decode of many CRAM streams in one launch, one thread per
// stream.
//
// Replaces disq_tpu/ops/rans_simd.py:_rans0_simd_kernel (kernel B3). Each
// stream has 4 interleaved states (state i & 3 decodes output byte i), a
// 12-bit frequency table summing to 4096 and byte-wise renormalization from
// below 2^23, at most 2 renorm bytes per symbol. The symbol of slot
// m = x & 0xFFF is min(255, |{r in 1..256 : cum[r] <= m}|), the reference's
// masked compare-and-sum, here read from a 4096-slot table. A renorm read past
// the stream's clen bytes yields 0 and never leaves the buffer; it still
// counts as consumed, so an overrun reports used > clen and status 6.
//
// Layout: stream i's renorm bytes are ren[ren_off[i] .. ren_off[i+1]) and its
// output out[out_off[i] .. out_off[i+1]) (the raw-size prefix sum), both int64
// offsets into one blob; states (n, 4) and freq (n, 256) are int32 rows. The
// TPU kernel's 128-lane one-hot gathers, its 96-bit per-lane bit buffer, its
// 8-row tile stores and its 64 KiB / 32,752-byte caps are not carried over.
//
// What bounds it on this card: latency. Every symbol is a chain of dependent
// steps (slot -> symbol -> freq/cum -> new state -> renorm byte), and a
// stream's symbols are serial, so one thread decodes one stream at the speed
// of that chain; a 64 MiB CRAM split holds a few dozen streams, far too few
// to fill the card. The bytes bound (each renorm byte read once, each output
// byte written once) is orders of magnitude below. What the design does about
// it: every table read is a shared-memory read — the stream's slot->symbol
// table (4096 bytes) and its 16-bit freq and cum rows live in shared memory,
// thread-minor (entry k of thread t at k * RANS_TPB + t) so a block's threads
// spread over the banks — the 4 states live in registers with the superstep
// unrolled, and the renorm bytes are read in place from the uploaded blob
// through the L1 cache, with no staging pass.

#include <cstdint>
#include <cuda_runtime.h>

#define RANS_TPB 8            // streams (threads) per block: 40 KB of tables
#define RANS_LOW (1u << 23)
#define TOTFREQ 4096

struct Tables {
  const uint8_t* lookup;   // slot -> symbol, stride RANS_TPB
  const uint16_t* freq;    // symbol -> frequency, stride RANS_TPB
  const uint16_t* cum;     // symbol -> cumulative frequency, stride RANS_TPB
  int t;
};

__device__ __forceinline__ uint32_t decode_symbol(
    uint32_t& x, const Tables& tb, const uint8_t* __restrict__ body,
    int64_t clen, int64_t& off) {
  uint32_t m = x & (TOTFREQ - 1);
  uint32_t s = tb.lookup[m * RANS_TPB + tb.t];
  x = (uint32_t)tb.freq[s * RANS_TPB + tb.t] * (x >> 12) + m -
      (uint32_t)tb.cum[s * RANS_TPB + tb.t];
  if (x < RANS_LOW) {  // <= 2 renorm bytes per symbol
    x = (x << 8) | (off < clen ? (uint32_t)body[off] : 0u);
    off++;
    if (x < RANS_LOW) {
      x = (x << 8) | (off < clen ? (uint32_t)body[off] : 0u);
      off++;
    }
  }
  return s;
}

__global__ void rans_simd_kernel(const uint8_t* __restrict__ ren,
                                 const int64_t* __restrict__ ren_off,
                                 const int64_t* __restrict__ out_off,
                                 const int32_t* __restrict__ states,
                                 const int32_t* __restrict__ freq, int64_t n,
                                 uint8_t* __restrict__ out,
                                 int64_t* __restrict__ used,
                                 int32_t* __restrict__ status) {
  __shared__ uint8_t s_lookup[TOTFREQ * RANS_TPB];
  __shared__ uint16_t s_freq[256 * RANS_TPB];
  __shared__ uint16_t s_cum[256 * RANS_TPB];
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * RANS_TPB + t;
  if (i >= n) return;  // no barrier below: each thread owns its tables

  // the stream's tables: freq/cum rows, and the slot table with every slot
  // past the total read as symbol 255 (the reference's clamp)
  const int32_t* f = freq + i * 256;
  for (int k = 0; k < TOTFREQ; k++) s_lookup[k * RANS_TPB + t] = 255;
  uint32_t c = 0;
  for (int s = 0; s < 256; s++) {
    uint32_t fs = (uint32_t)f[s];
    s_freq[s * RANS_TPB + t] = (uint16_t)fs;
    s_cum[s * RANS_TPB + t] = (uint16_t)c;
    uint32_t lo = c < TOTFREQ ? c : TOTFREQ;
    uint32_t hi = c + fs < TOTFREQ ? c + fs : TOTFREQ;
    for (uint32_t k = lo; k < hi; k++) s_lookup[k * RANS_TPB + t] = (uint8_t)s;
    c += fs;
  }
  Tables tb{s_lookup, s_freq, s_cum, t};

  const uint8_t* body = ren + ren_off[i];
  const int64_t clen = ren_off[i + 1] - ren_off[i];
  uint8_t* o = out + out_off[i];
  const int64_t raw = out_off[i + 1] - out_off[i];
  uint32_t x0 = (uint32_t)states[i * 4 + 0], x1 = (uint32_t)states[i * 4 + 1];
  uint32_t x2 = (uint32_t)states[i * 4 + 2], x3 = (uint32_t)states[i * 4 + 3];
  int64_t off = 0;
  int64_t k = 0;
  for (; k + 4 <= raw; k += 4) {  // one superstep: states 0..3 in order
    o[k] = (uint8_t)decode_symbol(x0, tb, body, clen, off);
    o[k + 1] = (uint8_t)decode_symbol(x1, tb, body, clen, off);
    o[k + 2] = (uint8_t)decode_symbol(x2, tb, body, clen, off);
    o[k + 3] = (uint8_t)decode_symbol(x3, tb, body, clen, off);
  }
  if (k < raw) o[k] = (uint8_t)decode_symbol(x0, tb, body, clen, off);
  if (k + 1 < raw) o[k + 1] = (uint8_t)decode_symbol(x1, tb, body, clen, off);
  if (k + 2 < raw) o[k + 2] = (uint8_t)decode_symbol(x2, tb, body, clen, off);
  used[i] = off;
  status[i] = off > clen ? 6 : 0;
}

extern "C" int disq_rans_simd_launch(const void* ren, const void* ren_off,
                                     const void* out_off, const void* states,
                                     const void* freq, int64_t n, void* out,
                                     void* used, void* status, void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + RANS_TPB - 1) / RANS_TPB);
  rans_simd_kernel<<<grid, RANS_TPB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ren, (const int64_t*)ren_off, (const int64_t*)out_off,
      (const int32_t*)states, (const int32_t*)freq, n, (uint8_t*)out,
      (int64_t*)used, (int32_t*)status);
  return (int)cudaGetLastError();
}
