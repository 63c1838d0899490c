// Read-filter keep mask (kernel F1): the samtools view -f/-F/-q/-s predicate
// over a batch's resident columns.
//
// Replaces disq_tpu/ops/rfilter.py:_mask_kernel (XLA code, not Pallas). For
// record i:
//
//   keep = (flag & req) == req  &&  (flag & exc) == 0  &&  mapq >= minq
//   x = name_hash ^ seed_mix; x ^= x >> 16; x *= MIX_A; x ^= x >> 15;
//   x *= MIX_B; x ^= x >> 16;  keep &= x < thresh
//
// in wrapping uint32 arithmetic, written as one byte of out. With no
// subsample the name hashes are absent (a null pointer) and read as 0, as
// the reference uploads zeros; seed_mix is then 0 and thresh 0xFFFFFFFF.
//
// What bounds it on this card: bytes, 13 per record (two int32 columns and
// the uint32 hash in, one byte out), a few microseconds at millions of
// records, so a launch costs more than the work. One thread per record; no
// shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#define FILTER_TPB 256

__global__ void __launch_bounds__(FILTER_TPB)
read_filter_kernel(const int32_t* __restrict__ flag,
                   const int32_t* __restrict__ mapq,
                   const uint32_t* __restrict__ name_hash, int64_t n,
                   uint32_t req, uint32_t exc, uint32_t minq,
                   uint32_t seed_mix, uint32_t thresh,
                   uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * FILTER_TPB + threadIdx.x;
  if (i >= n) return;
  const uint32_t f = (uint32_t)flag[i];
  const bool pass = ((f & req) == req) && ((f & exc) == 0u) &&
                    ((uint32_t)mapq[i] >= minq);
  uint32_t x = (name_hash != nullptr ? name_hash[i] : 0u) ^ seed_mix;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  out[i] = (pass && x < thresh) ? 1 : 0;
}

static int64_t filter_blocks(int64_t n) {
  return (n + FILTER_TPB - 1) / FILTER_TPB;
}

extern "C" int disq_read_filter_launch(const void* flag, const void* mapq,
                                       const void* name_hash, int64_t n,
                                       uint32_t req, uint32_t exc,
                                       uint32_t minq, uint32_t seed_mix,
                                       uint32_t thresh, void* out,
                                       void* stream) {
  if (n <= 0) return 0;
  read_filter_kernel<<<(unsigned)filter_blocks(n), FILTER_TPB, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)flag, (const int32_t*)mapq,
      (const uint32_t*)name_hash, n, req, exc, minq, seed_mix, thresh,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Launch geometry for n records: threads per block, records per block,
// shared memory per block in bytes, and blocks.
extern "C" void disq_read_filter_geometry(int64_t n, int64_t* g) {
  g[0] = FILTER_TPB;
  g[1] = FILTER_TPB;
  g[2] = 0;
  g[3] = filter_blocks(n);
}
