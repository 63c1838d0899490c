// Literal-only dynamic-Huffman body encode of BGZF payloads (kernel W2).
//
// Replaces disq_tpu/ops/deflate.py:_compiled.encode (XLA code, not Pallas):
// under one shared table, every byte of a payload (at most 65,280 bytes) is
// coded as its literal's code, LSB-first, starting at bit header_bits of the
// lane's body row; bits below header_bits stay zero (the host ORs the header
// in) and end_bits[lane] is the bit after the last code (the host ORs the
// end-of-block code there). A row's first occupied(end) bytes are written,
// occupied(end) = min(out_bytes, round16((end + 15 + 7) / 8)), zero from the
// end bit on; the rest of the row is left as it was. A lane whose length is
// not 0..65,280 gets end bit -1 and no row.
//
// What bounds it on this card: bytes. Per payload byte it reads one byte and
// writes its code (4.5-15 bits); the arithmetic is a table lookup, a scan and
// a few shifts. The dependency to break is the bit offset of each code, a
// prefix sum of code lengths over the whole payload. What the design does:
//
// - One CTA of 1,024 threads per payload, one launch for every payload of a
//   call (no lane chunks: the TPU's 128-lane layout has no meaning here).
// - The payload is staged into shared memory with 16-byte loads (byte loads
//   when its address is not 16-byte aligned), and the 256-entry table beside
//   it, packed as code | length << 16.
// - Each thread owns a contiguous run of R words of the payload. R is odd, so
//   the 32 lanes of a warp read their runs from 32 different banks. A thread
//   sums its run's code lengths; one block-wide exclusive scan (warp shuffles,
//   then one warp over the 32 warp sums) gives every run's first bit.
// - Each thread packs its run into the body, a shared-memory array of 32-bit
//   words: a 64-bit accumulator emits whole words; only the first and last
//   word of a run can be shared with a neighbour, and only those two take
//   atomicOr, the rest are plain stores.
// - The occupied prefix is copied to the row with 16-byte coalesced stores.
//
// Shared memory: table 1 KB + scan 256 B + payload 65,280 B + body out_bytes
// (≤ 122,928 B at 15-bit codes) ≈ 190 KB, one CTA per SM; above 48 KB it
// needs cudaFuncSetAttribute. No TMA or wgmma: there is no matrix product,
// and each payload is read once.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#define DEFLATE_TPB 1024
#define DEFLATE_WARPS (DEFLATE_TPB / 32)
#define MAX_PAYLOAD 65280
#define MAX_CODE_BITS 15
#define LUT_WORDS 256
#define SCAN_WORDS 64
// byte offset of the payload, then of the body, in dynamic shared memory
#define PAYLOAD_AT (4 * (LUT_WORDS + SCAN_WORDS))
#define BODY_AT (PAYLOAD_AT + MAX_PAYLOAD)

static_assert(PAYLOAD_AT % 16 == 0 && BODY_AT % 16 == 0,
              "16-byte vectors in shared memory");

__device__ __forceinline__ int64_t occupied(int64_t end_bit,
                                            int64_t out_bytes) {
  int64_t occ = ((end_bit + MAX_CODE_BITS + 7) / 8 + 15) / 16 * 16;
  return occ < out_bytes ? occ : out_bytes;
}

__global__ void __launch_bounds__(DEFLATE_TPB, 1)
deflate_kernel(const uint8_t* __restrict__ payload,
               const int64_t* __restrict__ pay_off,
               const int32_t* __restrict__ pay_len,
               const int32_t* __restrict__ code_lut,
               const int32_t* __restrict__ len_lut, int32_t header_bits,
               int64_t out_bytes, uint8_t* __restrict__ out,
               int32_t* __restrict__ end_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  uint32_t* scan = lut + LUT_WORDS;
  unsigned char* pay = smem + PAYLOAD_AT;
  const uint32_t* pay_w = reinterpret_cast<const uint32_t*>(pay);
  uint32_t* body = reinterpret_cast<uint32_t*>(smem + BODY_AT);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t b = blockIdx.x;
  const uint8_t* src = payload + pay_off[b];
  const int len = pay_len[b];
  if (len < 0 || len > MAX_PAYLOAD) {  // not a BGZF payload: flagged, no row
    if (t == 0) end_bits[b] = -1;
    return;
  }

  if (t < LUT_WORDS) {
    lut[t] = ((uint32_t)code_lut[t] & 0xFFFF) | ((uint32_t)len_lut[t] << 16);
  }
  if (((uintptr_t)src & 15) == 0) {
    const int nvec = len / 16;
    for (int v = t; v < nvec; v += DEFLATE_TPB) {
      reinterpret_cast<uint4*>(pay)[v] =
          __ldg(reinterpret_cast<const uint4*>(src) + v);
    }
    for (int i = 16 * nvec + t; i < len; i += DEFLATE_TPB) pay[i] = src[i];
  } else {
    for (int i = t; i < len; i += DEFLATE_TPB) pay[i] = src[i];
  }
  __syncthreads();

  // this thread's run: words [w0, w1) of the payload, bytes below hi
  const int words = (len + 3) / 4;
  int run = (words + DEFLATE_TPB - 1) / DEFLATE_TPB;
  run += (run & 1) ^ 1;  // odd: a warp's runs start in 32 different banks
  const int w0 = min(t * run, words), w1 = min(w0 + run, words);
  const int hi = min(4 * w1, len);

  uint32_t bits = 0;
  for (int w = w0; w < w1; w++) {
    const uint32_t v = pay_w[w];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      if (4 * w + k < hi) bits += lut[(v >> (8 * k)) & 0xFF] >> 16;
    }
  }

  // block-wide exclusive scan of the runs' bit counts
  uint32_t incl = bits;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < DEFLATE_WARPS ? scan[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    scan[32 + lane] = s;  // inclusive prefix over warps
  }
  __syncthreads();
  const uint32_t before = (warp ? scan[32 + warp - 1] : 0) + incl - bits;
  const int64_t end_bit = (int64_t)header_bits + scan[32 + DEFLATE_WARPS - 1];
  const int64_t occ = occupied(end_bit, out_bytes);

  for (int i = t; i < occ / 4; i += DEFLATE_TPB) body[i] = 0;
  __syncthreads();

  // words past the occupied prefix are never written (only a table whose
  // lengths exceed the rows' bound could reach them)
  const uint32_t lim = (uint32_t)(occ / 4);
  if (bits) {
    const uint32_t p0 = (uint32_t)header_bits + before;
    uint32_t wi = p0 >> 5;
    int nacc = p0 & 31;
    uint64_t acc = 0;
    bool first = true;
    for (int w = w0; w < w1; w++) {
      const uint32_t v = pay_w[w];
#pragma unroll
      for (int k = 0; k < 4; k++) {
        if (4 * w + k < hi) {
          const uint32_t e = lut[(v >> (8 * k)) & 0xFF];
          acc |= (uint64_t)(e & 0xFFFF) << nacc;
          nacc += e >> 16;
          if (nacc >= 32) {
            if (wi < lim) {
              if (first) {
                atomicOr(&body[wi], (uint32_t)acc);  // shared with the run before
              } else {
                body[wi] = (uint32_t)acc;
              }
            }
            first = false;
            acc >>= 32;
            nacc -= 32;
            wi++;
          }
        }
      }
    }
    if (nacc > 0 && wi < lim) atomicOr(&body[wi], (uint32_t)acc);  // and next
  }
  __syncthreads();

  uint4* row = reinterpret_cast<uint4*>(out + b * out_bytes);
  const uint4* body_v = reinterpret_cast<const uint4*>(body);
  for (int i = t; i < occ / 16; i += DEFLATE_TPB) row[i] = body_v[i];
  if (t == 0) end_bits[b] = (int32_t)end_bit;
}

static int64_t smem_bytes(int64_t out_bytes) { return BODY_AT + out_bytes; }

#define MAX_DEVICES 64
static std::atomic<bool> smem_configured[MAX_DEVICES];

// rows for 15-bit codes: the widest a table can ask for
static const int64_t WIDEST_ROW =
    ((4096 + (int64_t)MAX_PAYLOAD * MAX_CODE_BITS + MAX_CODE_BITS) / 8 + 2 +
     15) / 16 * 16;

extern "C" int disq_deflate_launch(const void* payload, const void* pay_off,
                                   const void* pay_len, const void* code_lut,
                                   const void* len_lut, int32_t header_bits,
                                   int64_t out_bytes, int64_t n, void* out,
                                   void* end_bits, void* stream) {
  if (n <= 0) return 0;
  if (out_bytes % 16 != 0 || out_bytes > WIDEST_ROW) {
    return (int)cudaErrorInvalidValue;
  }
  // once per device, for the widest rows (so not while a graph captures)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_configured[dev].load()) {
    err = cudaFuncSetAttribute(deflate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(WIDEST_ROW));
    if (err != cudaSuccess) return (int)err;
    smem_configured[dev].store(true);
  }
  const int64_t smem = smem_bytes(out_bytes);
  deflate_kernel<<<(unsigned)n, DEFLATE_TPB, (size_t)smem,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int64_t*)pay_off,
      (const int32_t*)pay_len, (const int32_t*)code_lut,
      (const int32_t*)len_lut, header_bits, out_bytes, (uint8_t*)out,
      (int32_t*)end_bits);
  return (int)cudaGetLastError();
}

// Launch geometry for n payloads at the widest rows (15-bit codes):
// threads per block, payloads per block, shared memory per block in bytes,
// and blocks.
extern "C" void disq_deflate_geometry(int64_t n, int64_t* g) {
  g[0] = DEFLATE_TPB;
  g[1] = 1;
  g[2] = smem_bytes(WIDEST_ROW);
  g[3] = n;
}
