// rANS-4x8 order-0 decode, one thread block per stream (the legacy route).
//
// Replaces disq_tpu/ops/rans.py:_rans0_kernel (kernel B5), which decodes one
// stream per grid program through a 4096-slot symbol lookup. It computes the
// function of rans_simd.cu: 4 interleaved states, 12-bit frequencies, at most
// 2 renorm bytes per symbol, a renorm read past clen yields 0 and counts as
// consumed, and status 6 when used > clen. The inputs and outputs are laid out
// as for rans_simd.cu (one renorm blob and one output blob at int64 offsets,
// states (n, 4) and freq (n, 256) int32 rows).
//
// What bounds it on this card: latency, as for rans_simd.cu — one thread runs
// the stream's serial chain of dependent steps. What the design does about it:
// the block's threads build the stream's lookup (slot -> symbol) and its
// freq/cum rows in shared memory together, each thread one symbol, so the
// serial part is the decode alone, with every table read from shared memory
// and the states in registers; the renorm bytes are read in place.

#include <cstdint>
#include <cuda_runtime.h>

#define LEGACY_TPB 256
#define RANS_LOW (1u << 23)
#define TOTFREQ 4096

__device__ __forceinline__ uint32_t legacy_symbol(
    uint32_t& x, const uint8_t* lookup, const uint32_t* fr, const uint32_t* cm,
    const uint8_t* __restrict__ body, int64_t clen, int64_t& off) {
  uint32_t m = x & (TOTFREQ - 1);
  uint32_t s = lookup[m];
  x = fr[s] * (x >> 12) + m - cm[s];
  for (int r = 0; r < 2; r++) {  // <= 2 renorm bytes per symbol
    if (x < RANS_LOW) {
      x = (x << 8) | (off < clen ? (uint32_t)body[off] : 0u);
      off++;
    }
  }
  return s;
}

__global__ void rans_legacy_kernel(const uint8_t* __restrict__ ren,
                                   const int64_t* __restrict__ ren_off,
                                   const int64_t* __restrict__ out_off,
                                   const int32_t* __restrict__ states,
                                   const int32_t* __restrict__ freq,
                                   uint8_t* __restrict__ out,
                                   int64_t* __restrict__ used,
                                   int32_t* __restrict__ status) {
  __shared__ uint8_t s_lookup[TOTFREQ];
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_cum[256];
  const int64_t i = blockIdx.x;
  const int t = threadIdx.x;  // one symbol per thread while building

  const int32_t* f = freq + i * 256;
  s_freq[t] = (uint32_t)f[t];
  for (int k = t; k < TOTFREQ; k += LEGACY_TPB) s_lookup[k] = 255;
  __syncthreads();
  uint32_t c = 0;
  for (int s = 0; s < t; s++) c += s_freq[s];
  s_cum[t] = c;
  __syncthreads();  // every slot is 255 before any symbol's range is set
  uint32_t lo = c < TOTFREQ ? c : TOTFREQ;
  uint32_t hi = c + s_freq[t] < TOTFREQ ? c + s_freq[t] : TOTFREQ;
  for (uint32_t k = lo; k < hi; k++) s_lookup[k] = (uint8_t)t;
  __syncthreads();
  if (t != 0) return;

  const uint8_t* body = ren + ren_off[i];
  const int64_t clen = ren_off[i + 1] - ren_off[i];
  uint8_t* o = out + out_off[i];
  const int64_t raw = out_off[i + 1] - out_off[i];
  uint32_t x[4];
  for (int j = 0; j < 4; j++) x[j] = (uint32_t)states[i * 4 + j];
  int64_t off = 0;
  for (int64_t k = 0; k < raw; k += 4) {
#pragma unroll
    for (int j = 0; j < 4; j++)
      if (k + j < raw)
        o[k + j] = (uint8_t)legacy_symbol(x[j], s_lookup, s_freq, s_cum, body,
                                          clen, off);
  }
  used[i] = off;
  status[i] = off > clen ? 6 : 0;
}

extern "C" int disq_rans_legacy_launch(const void* ren, const void* ren_off,
                                       const void* out_off, const void* states,
                                       const void* freq, int64_t n, void* out,
                                       void* used, void* status,
                                       void* stream) {
  if (n <= 0) return 0;
  rans_legacy_kernel<<<(unsigned)n, LEGACY_TPB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ren, (const int64_t*)ren_off, (const int64_t*)out_off,
      (const int32_t*)states, (const int32_t*)freq, (uint8_t*)out,
      (int64_t*)used, (int32_t*)status);
  return (int)cudaGetLastError();
}
