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
// All 32 lanes of the warp run the decode in lockstep on the same values
// (shared-memory reads are broadcasts); the lanes split the table build
// and the ring refills, and lane 0 stores the output. Only 4 states exist
// per stream, so a launch holds one warp per stream and cannot fill the
// card: a split's ~48 streams occupy ~48 SMs.

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

  // -- the renorm ring: linear position P = byte offset from a0 -----------
  const uint8_t* body = ren + ren_off[i];
  const int64_t clen = ren_off[i + 1] - ren_off[i];
  Ring ring;
  ring.buf = s_ring;
  ring.a0 = (uintptr_t)body & ~(uintptr_t)15;
  ring.end = (uintptr_t)body + (uintptr_t)clen;
  ring.lane = lane;
  const int64_t head = (int64_t)((uintptr_t)body - ring.a0);
  ring_fill(s_ring, ring.a0, ring.end, 0, lane);
  ring_fill(s_ring, ring.a0, ring.end, HALF, lane);
  ring_wait();  // also orders the table writes before the decode
  ring.issued = RING;
  ring.pending = false;
  ring.trigger = HALF + MARGIN - 1;
  const uint64_t* ring64 = reinterpret_cast<const uint64_t*>(s_ring);

  // -- the decode: output in aligned words, stitched across the stream's
  // misalignment a; the head and tail bytes are stored singly ------------
  uint8_t* o = out + out_off[i];
  const int64_t raw = out_off[i + 1] - out_off[i];
  const int64_t full = raw >> 2;
  const uint32_t a = (uint32_t)((uintptr_t)o & 3);
  uint32_t* ow = reinterpret_cast<uint32_t*>(o - a);  // aligned words
  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; j++) x[j] = (uint32_t)states[i * 4 + j];
  int64_t P = head;  // the read offset's linear position: used = P - head
  uint32_t prev = 0;
  if (full > 0) {
    ring.keep(P);
    prev = superstep<true>(x, P, s_tab, ring64);
    if (lane == 0)
      for (uint32_t j = 0; j < 4 - a; j++) o[j] = (uint8_t)(prev >> (8 * j));
  }
  int64_t k = 1;
  for (; k + GROUP <= full; k += GROUP) {
    ring.keep(P);
#pragma unroll
    for (int j = 0; j < GROUP; j++) {
      const uint32_t word = superstep<true>(x, P, s_tab, ring64);
      // the previous superstep's last a bytes and this one's first 4 - a
      if (lane == 0) ow[k + j] = __funnelshift_l(prev, word, 8 * a);
      prev = word;
    }
  }
  for (; k < full; k++) {
    ring.keep(P);
    const uint32_t word = superstep<true>(x, P, s_tab, ring64);
    if (lane == 0) ow[k] = __funnelshift_l(prev, word, 8 * a);
    prev = word;
  }
  if (lane == 0 && full > 0)
    for (uint32_t j = 0; j < a; j++)
      o[4 * full - a + j] = (uint8_t)(prev >> (8 * (4 - a + j)));
  const int rem = (int)(raw & 3);
  if (rem) {
    ring.keep(P);
    const uint32_t word = superstep<false>(x, P, s_tab, ring64, rem);
    if (lane == 0)
      for (int j = 0; j < rem; j++) o[4 * full + j] = (uint8_t)(word >> (8 * j));
  }
  ring_wait();  // no refill may land in shared memory after the block exits
  if (lane == 0) {
    used[i] = P - head;
    status[i] = P - head > clen ? 6 : 0;
  }
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
