// rANS-4x8 order-0 decode of many CRAM streams in one launch, one warp per
// stream.
//
// Replaces disq_tpu/ops/rans_simd.py:_rans0_simd_kernel (kernel B3). Each
// stream has 4 interleaved states (state i & 3 decodes output byte i), a
// 12-bit frequency table summing to 4096 and byte-wise renormalization from
// below 2^23, at most 2 renorm bytes per symbol. The symbol of slot
// m = x & 0xFFF is min(255, |{r in 1..256 : cum[r] <= m}|), the reference's
// masked compare-and-sum: slots at or past the row's total read as symbol
// 255 (the clamp rule). A renorm read past the stream's clen bytes yields 0
// and never leaves the buffer; it still counts as consumed, so an overrun
// reports used > clen and status 6. The plain version, rans0_decode_plain in
// disq_tpu_torch/ops/rans_simd.py, defines the function.
//
// Layout: stream i's renorm bytes are ren[ren_off[i] .. ren_off[i+1]) and its
// output out[out_off[i] .. out_off[i+1]) (the raw-size prefix sum), both int64
// offsets into one blob; states (n, 4) and freq (n, 256) are int32 rows.
//
// What bounds it on this card: latency. A stream's symbols are serial, a
// 64 MiB CRAM split holds only a few dozen streams of ~1.5 MB, and the bytes
// bound (each renorm byte read once, each output byte written once) is
// orders of magnitude below the time of one stream's dependent chain. Only
// the chain per superstep (4 output bytes) can be shortened:
//
// - One packed entry per slot. The stream's block (one warp) builds a
//   4096-entry table in shared memory: {freq, (slot - cum[sym]) | sym << 24}
//   as one 64-bit word, so a symbol is one shared-memory load and one
//   multiply-add. The 32-bit frequency half holds a one-symbol stream's
//   4096 (13 bits) and the clamp slots of a row that sums below 4096.
// - The four states of a superstep decode together in one thread's
//   registers. Their slot lookups are independent; each state's renorm
//   count (0, 1 or 2) follows from its new value alone (one byte below
//   2^23, two below 2^15), so the four byte offsets are an exclusive
//   prefix sum of the counts, one 8-byte window at the stream's read
//   offset serves all four states, and each state takes its bytes with
//   two byte permutes (prmt): no shift by a data-dependent count.
// - Renorm bytes come from a 4 KiB ring in shared memory that the warp
//   fills with 16-byte cp.async copies one half ahead of the decoder.
//   Bytes at and past clen are zero-filled in the ring, so a read there
//   yields 0 without a per-byte bounds compare and still counts in used.
//   The ring is checked once per GROUP supersteps, and the full
//   supersteps run unrolled with no test for the stream's head or tail.
// - Output leaves as aligned 32-bit words (one per superstep, stitched
//   across the stream's misalignment with a funnel shift); the head and
//   tail bytes are stored singly.
//
// The decode (ring, superstep, output words) lives in csrc/rans_core.cuh,
// shared with B5 (csrc/rans.cu); this kernel builds its slot table by the
// masked compare-and-sum's rule.
//
// All 32 lanes of the warp run the decode in lockstep on the same values
// (shared-memory reads are broadcasts); the lanes split the table build
// and the ring refills, and lane 0 stores the output. Only 4 states exist
// per stream, so a launch holds one warp per stream and cannot fill the
// card: a split's ~48 streams occupy ~48 SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "rans_core.cuh"

__global__ void __launch_bounds__(32)
rans_simd_kernel(const uint8_t* __restrict__ ren,
                 const int64_t* __restrict__ ren_off,
                 const int64_t* __restrict__ out_off,
                 const int32_t* __restrict__ states,
                 const int32_t* __restrict__ freq, int64_t n,
                 uint8_t* __restrict__ out, int64_t* __restrict__ used,
                 int32_t* __restrict__ status) {
  __shared__ uint2 s_tab[TOTFREQ];
  __shared__ __align__(16) uint8_t s_ring[RING];
  const int lane = threadIdx.x;
  const int64_t i = blockIdx.x;
  if (i >= n) return;

  // -- the slot table: lane l owns symbols 8l .. 8l+7 ---------------------
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
  const uint32_t total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  const uint32_t f255 = __shfl_sync(0xFFFFFFFFu, fs[7], 31);
  const uint32_t cum255 = total - f255;
  // slots past the row's total read as symbol 255 (the reference's clamp)
  const uint32_t clamp_lo = total < TOTFREQ ? total : TOTFREQ;
  for (uint32_t m = lane; m < TOTFREQ; m += 32)
    if (m >= clamp_lo)
      s_tab[m] = make_uint2(f255, ((m - cum255) & 0xFFFFFFu) | (255u << 24));
  uint32_t c = incl - mine;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t lo = c < TOTFREQ ? c : TOTFREQ;
    uint32_t hi = c + fs[k] < TOTFREQ ? c + fs[k] : TOTFREQ;
    uint32_t sym = (uint32_t)(lane * 8 + k) << 24;
    for (uint32_t m = lo; m < hi; m++)
      s_tab[m] = make_uint2(fs[k], ((m - c) & 0xFFFFFFu) | sym);
    c += fs[k];
  }
  decode_stream(s_tab, s_ring, ren + ren_off[i], ren_off[i + 1] - ren_off[i],
                out + out_off[i], out_off[i + 1] - out_off[i], states + i * 4,
                lane, used + i, status + i);
}

extern "C" int disq_rans_simd_launch(const void* ren, const void* ren_off,
                                     const void* out_off, const void* states,
                                     const void* freq, int64_t n, void* out,
                                     void* used, void* status, void* stream) {
  if (n <= 0) return 0;
  rans_simd_kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ren, (const int64_t*)ren_off, (const int64_t*)out_off,
      (const int32_t*)states, (const int32_t*)freq, n, (uint8_t*)out,
      (int64_t*)used, (int32_t*)status);
  return (int)cudaGetLastError();
}

// Launch geometry for n streams: threads per block, streams per block,
// shared memory per block (static + dynamic, bytes), blocks.
extern "C" void disq_rans_simd_geometry(int64_t n, int64_t* g) {
  g[0] = 32;
  g[1] = 1;
  g[2] = (int64_t)(sizeof(uint2) * TOTFREQ + RING);
  g[3] = n > 0 ? n : 0;
}
