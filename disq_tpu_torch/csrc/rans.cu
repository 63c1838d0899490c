// rANS-4x8 order-0 decode through the slot lookup, one warp per stream
// (kernel B5, the legacy route).
//
// Replaces disq_tpu/ops/rans.py:_rans0_kernel, which decodes one stream per
// grid program through a 4096-slot symbol lookup that its wrapper builds:
// symbol s repeated freq[s] times, every slot past the row's total read as
// symbol 255. It computes the function of csrc/rans_simd.cu (B3): 4
// interleaved states, 12-bit frequencies, at most 2 renorm bytes per
// symbol, a renorm read past clen yields 0 and counts as consumed, and
// status 6 when used > clen. The inputs and outputs are laid out as for
// rans_simd.cu (one renorm blob and one output blob at int64 offsets,
// states (n, 4) and freq (n, 256) int32 rows). The plain version,
// rans0_decode_plain in disq_tpu_torch/ops/rans.py, defines the function.
//
// What bounds it on this card: latency, as for rans_simd.cu -- a stream's
// symbols are one serial chain, and a split holds only a few dozen streams.
// The design is B3's, whose decode both kernels share through
// csrc/rans_core.cuh: one warp per stream, a packed 64-bit slot table, a
// renorm-byte ring filled by cp.async one half ahead, the four states of a
// superstep decoded together from one 8-byte window, aligned word output.
// Only the table step is this route's own: the warp first builds the
// stream's 4096-byte slot -> symbol lookup as the reference's wrapper does
// (255 everywhere, then each symbol's run of slots, lane l filling symbols
// 8l .. 8l+7), and then fills each packed entry from it,
// {freq[sym], (slot - cum[sym]) | sym << 24} with sym = lookup[slot].

#include <cstdint>
#include <cuda_runtime.h>

#include "rans_core.cuh"

__global__ void __launch_bounds__(32)
rans_legacy_kernel(const uint8_t* __restrict__ ren,
                   const int64_t* __restrict__ ren_off,
                   const int64_t* __restrict__ out_off,
                   const int32_t* __restrict__ states,
                   const int32_t* __restrict__ freq, int64_t n,
                   uint8_t* __restrict__ out, int64_t* __restrict__ used,
                   int32_t* __restrict__ status) {
  __shared__ uint2 s_tab[TOTFREQ];
  __shared__ __align__(16) uint8_t s_ring[RING];
  __shared__ __align__(16) uint8_t s_lookup[TOTFREQ];
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_cum[256];
  const int lane = threadIdx.x;
  const int64_t i = blockIdx.x;
  if (i >= n) return;

  // -- cumulative frequencies: lane l owns symbols 8l .. 8l+7 --------------
  const int32_t* f = freq + i * 256;
  uint32_t fs[8], mine = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    fs[k] = (uint32_t)f[lane * 8 + k];
    mine += fs[k];
  }
  uint32_t incl = mine;  // inclusive scan of the lanes' sums (mod 2^32)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }

  // -- the lookup: 255 in every slot, then each symbol's run --------------
  uint4* l4 = reinterpret_cast<uint4*>(s_lookup);
  for (int m = lane; m < TOTFREQ / 16; m += 32)
    l4[m] = make_uint4(~0u, ~0u, ~0u, ~0u);
  __syncwarp();  // every slot is 255 before any symbol's run is set
  uint32_t c = incl - mine;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int s = lane * 8 + k;
    s_freq[s] = fs[k];
    s_cum[s] = c;
    uint32_t lo = c < TOTFREQ ? c : TOTFREQ;
    uint32_t hi = c + fs[k] < TOTFREQ ? c + fs[k] : TOTFREQ;
    for (uint32_t m = lo; m < hi; m++) s_lookup[m] = (uint8_t)s;
    c += fs[k];
  }
  __syncwarp();

  // -- the packed entries, each from its slot's symbol ---------------------
  for (uint32_t m = lane; m < TOTFREQ; m += 32) {
    const uint32_t s = s_lookup[m];
    s_tab[m] = make_uint2(s_freq[s], ((m - s_cum[s]) & 0xFFFFFFu) | s << 24);
  }
  decode_stream(s_tab, s_ring, ren + ren_off[i], ren_off[i + 1] - ren_off[i],
                out + out_off[i], out_off[i + 1] - out_off[i], states + i * 4,
                lane, used + i, status + i);
}

extern "C" int disq_rans_legacy_launch(const void* ren, const void* ren_off,
                                       const void* out_off, const void* states,
                                       const void* freq, int64_t n, void* out,
                                       void* used, void* status,
                                       void* stream) {
  if (n <= 0) return 0;
  rans_legacy_kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ren, (const int64_t*)ren_off, (const int64_t*)out_off,
      (const int32_t*)states, (const int32_t*)freq, n, (uint8_t*)out,
      (int64_t*)used, (int32_t*)status);
  return (int)cudaGetLastError();
}

// Launch geometry for n streams: threads per block, streams per block,
// shared memory per block (static, bytes), blocks.
extern "C" void disq_rans_geometry(int64_t n, int64_t* g) {
  g[0] = 32;
  g[1] = 1;
  g[2] = (int64_t)(sizeof(uint2) * TOTFREQ + RING + TOTFREQ +
                   2 * 256 * sizeof(uint32_t));
  g[3] = n > 0 ? n : 0;
}
