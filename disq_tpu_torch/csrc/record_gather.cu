// Resident record gather: a shard's records, in the sort's order, copied from
// the record blob into one contiguous payload (kernel W1).
//
// Replaces disq_tpu/runtime/device_write.py:_gather_compiled (XLA code, not
// Pallas): record i's bytes blob[src[i] : src[i] + (dst[i+1] - dst[i])] go to
// out[dst[i] : dst[i+1]]. The BAM encode of an unmodified record is its
// decoded bytes, so this gather is the shard's record encode. Offsets are
// int64 throughout: no 2 GiB limit.
//
// What bounds it on this card: bytes. Every payload byte is read once and
// written once (plus 16 bytes of offsets per record); there is no arithmetic.
// Records are a few hundred bytes at arbitrary byte offsets on both sides,
// so source and destination are misaligned against each other. What the
// design does:
//
// - One warp per record. Each lane writes whole aligned 32-bit words of the
//   record's destination, neighbouring lanes neighbouring words, so a warp
//   stores 128 contiguous bytes at a time. The up to 3 bytes before the first
//   aligned word and after the last go out as single bytes: those words are
//   shared with the neighbouring records, which other warps write.
// - Each destination word is assembled from the two aligned source words that
//   cover it with one funnel shift (one word when the source is aligned too).
//   Both are read only where they hold a byte of the record, so no load
//   leaves the blob's allocation.

#include <cstdint>
#include <cuda_runtime.h>

#define GATHER_TPB 256
#define GATHER_WARPS (GATHER_TPB / 32)

__global__ void __launch_bounds__(GATHER_TPB)
record_gather_kernel(const uint8_t* __restrict__ blob,
                     const int64_t* __restrict__ src,
                     const int64_t* __restrict__ dst, int64_t n,
                     uint8_t* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * GATHER_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const int64_t d = dst[r], len = dst[r + 1] - d;
  if (len <= 0) return;
  const uint8_t* in = blob + src[r];
  uint8_t* o = out + d;
  const int64_t head_room = (int64_t)((4 - ((uintptr_t)o & 3)) & 3);
  const int64_t head = len < head_room ? len : head_room;
  const int64_t words = (len - head) >> 2;
  const int64_t tail_at = head + 4 * words;
  if (lane < head) o[lane] = in[lane];
  if (lane >= 4 && lane - 4 < len - tail_at) {
    o[tail_at + lane - 4] = in[tail_at + lane - 4];
  }
  uint32_t* ow = reinterpret_cast<uint32_t*>(o + head);
  const uintptr_t a = (uintptr_t)(in + head);
  const uint32_t* iw = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const unsigned sh = 8 * (unsigned)(a & 3);
  if (sh == 0) {
    for (int64_t w = lane; w < words; w += 32) ow[w] = __ldg(iw + w);
  } else {
    for (int64_t w = lane; w < words; w += 32) {
      ow[w] = __funnelshift_r(__ldg(iw + w), __ldg(iw + w + 1), sh);
    }
  }
}

static int64_t gather_blocks(int64_t n) {
  return (n + GATHER_WARPS - 1) / GATHER_WARPS;
}

extern "C" int disq_record_gather_launch(const void* blob, const void* src,
                                         const void* dst, int64_t n,
                                         void* out, void* stream) {
  if (n <= 0) return 0;
  record_gather_kernel<<<(unsigned)gather_blocks(n), GATHER_TPB, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)blob, (const int64_t*)src, (const int64_t*)dst, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Launch geometry for n records: threads per block, records per block,
// shared memory per block in bytes, and blocks.
extern "C" void disq_record_gather_geometry(int64_t n, int64_t* g) {
  g[0] = GATHER_TPB;
  g[1] = GATHER_WARPS;
  g[2] = 0;
  g[3] = gather_blocks(n);
}
