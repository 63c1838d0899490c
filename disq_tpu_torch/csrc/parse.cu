// BAM fixed-field parse straight from the decoded blob, one thread per record.
//
// Replaces disq_tpu/ops/parse.py:_parse_kernel together with the gather
// that feeds it (disq_tpu/runtime/device_pipeline.py:gather_record_words):
// each record's 36-byte prefix (block_size plus the 32-byte fixed section,
// SAM spec 4.2) is read little-endian at its unaligned start offset and
// split into 12 int32 fields by shifts and masks, written as 12 separate
// columns (SoA) in the order of _FIELD_ORDER in ops/parse.py. Bytes at or
// past the blob's end read as zero.
//
// What bounds it on this card: bytes. Per record it reads 8 bytes of start
// offset and 36 bytes of prefix and writes 48 bytes; the arithmetic is a
// handful of integer ops. What the design does about it: the prefix is read
// in place from the inflate kernel's output — no gather pass, no staged
// (N, 9) word array, no re-upload — and each thread's 12 stores go to 12
// columns with neighbouring threads on neighbouring addresses, so the
// writes coalesce. The unaligned prefix reads are byte loads; records of a
// warp sit next to each other in the blob, so their lines are shared.

#include <cstdint>
#include <cuda_runtime.h>

#define PARSE_TPB 256
#define N_FIELDS 12

__device__ __forceinline__ uint32_t load_u32(const uint8_t* __restrict__ blob,
                                             int64_t len, int64_t at) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int64_t b = at + k;
    uint32_t byte = (b >= 0 && b < len) ? blob[b] : 0u;
    v |= byte << (8 * k);
  }
  return v;
}

__global__ void parse_kernel(const uint8_t* __restrict__ blob, int64_t len,
                             const int64_t* __restrict__ starts, int64_t n,
                             int32_t* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t s = starts[i];
  uint32_t w[9];
#pragma unroll
  for (int k = 0; k < 9; k++) w[k] = load_u32(blob, len, s + 4 * k);
  int32_t f[N_FIELDS] = {
      (int32_t)w[0],                  // block_size
      (int32_t)w[1],                  // refid
      (int32_t)w[2],                  // pos
      (int32_t)(w[3] & 0xFF),         // l_read_name
      (int32_t)((w[3] >> 8) & 0xFF),  // mapq
      (int32_t)(w[3] >> 16),          // bin
      (int32_t)(w[4] & 0xFFFF),       // n_cigar
      (int32_t)(w[4] >> 16),          // flag
      (int32_t)w[5],                  // l_seq
      (int32_t)w[6],                  // next_refid
      (int32_t)w[7],                  // next_pos
      (int32_t)w[8],                  // tlen
  };
#pragma unroll
  for (int k = 0; k < N_FIELDS; k++) out[(int64_t)k * n + i] = f[k];
}

extern "C" int disq_parse_launch(const void* blob, int64_t len,
                                 const void* starts, int64_t n, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + PARSE_TPB - 1) / PARSE_TPB);
  parse_kernel<<<grid, PARSE_TPB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blob, len, (const int64_t*)starts, n, (int32_t*)out);
  return (int)cudaGetLastError();
}
