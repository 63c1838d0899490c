// BAM fixed-field parse straight from the decoded blob.
//
// Replaces disq_tpu/ops/parse.py:_parse_kernel together with the gather
// that feeds it (disq_tpu/runtime/device_pipeline.py:gather_record_words):
// each record's 36-byte prefix (block_size plus the 32-byte fixed section,
// SAM spec 4.2) is read little-endian at its unaligned start offset and
// split into 12 int32 fields by shifts and masks, written as 12 separate
// columns (SoA) in the order of _FIELD_ORDER in ops/parse.py. Bytes at or
// past the blob's end read as zero.
//
// What bounds it on this card: bytes. Per record it must read 8 bytes of
// start offset and 36 bytes of prefix and write 48 bytes; the arithmetic is
// a few dozen integer ops. Records sit hundreds of bytes apart in the blob,
// so each prefix comes from memory as whole 32-byte sectors (two, sometimes
// three), and every lane of a warp's prefix load touches sectors of its
// own: a byte-wise read pays 36 such warp-wide scatters per record. What
// the design does about it:
//
// - Fast path, for a record whose 36 bytes lie inside the blob: the prefix
//   is read as the 3 aligned 16-byte vectors (4 when the address is 13-15
//   bytes past a 16-byte boundary) that cover it, through the read-only
//   path, and the 9 words are recovered with two word selects and one
//   funnel shift each. The alignment is taken on the absolute address of
//   blob + start (the blob may be a view at any byte offset of a larger
//   allocation), so every vector loaded holds at least one prefix byte and
//   no load reaches past the last aligned word that holds a blob byte.
// - Slow path, for a start whose prefix runs past the blob's end (or lies
//   before it): byte loads, zero outside the blob.
// - One record per thread, 256 threads per block (32 registers). Two or
//   four records per thread, each thread's loads all in flight before any
//   is used, measured 5-10 % slower on the card: they take 62-90
//   registers, so fewer threads are resident. Starts are read and columns
//   written by neighbouring lanes at neighbouring addresses, so both
//   coalesce.
//
// No shared memory, TMA or wgmma: there is no matrix product, no record's
// bytes are read twice, and a TMA box tiles a dense array, not 36-byte
// records at data-dependent offsets.

#include <cstdint>
#include <cuda_runtime.h>

#define PARSE_TPB 256
#define N_FIELDS 12
#define PREFIX 36

// Prefix byte ``at`` of the blob, zero outside it (the slow path).
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

// The 9 little-endian words of a prefix that starts ``mis`` bytes into the
// 16-byte-aligned window ``v`` (64 bytes; the 4th vector is read only when
// the prefix reaches it).
__device__ __forceinline__ void window_words(const uint4 (&v)[4], unsigned mis,
                                             uint32_t (&w)[9]) {
  const uint32_t u[16] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y,
                          v[1].z, v[1].w, v[2].x, v[2].y, v[2].z, v[2].w,
                          v[3].x, v[3].y, v[3].z, v[3].w};
  // x[j] = u[j + mis / 4], by two selects: the word index is data, and a
  // dynamic index into registers would spill to local memory
  const bool two = mis & 8, one = mis & 4;
  uint32_t t[11], x[10];
#pragma unroll
  for (int j = 0; j < 11; j++) t[j] = two ? u[j + 2] : u[j];
#pragma unroll
  for (int j = 0; j < 10; j++) x[j] = one ? t[j + 1] : t[j];
  const unsigned sh = 8 * (mis & 3);
#pragma unroll
  for (int k = 0; k < 9; k++) w[k] = __funnelshift_r(x[k], x[k + 1], sh);
}

__global__ void __launch_bounds__(PARSE_TPB)
parse_kernel(const uint8_t* __restrict__ blob, int64_t len,
             const int64_t* __restrict__ starts, int64_t n,
             int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * PARSE_TPB + threadIdx.x;
  if (i >= n) return;
  const int64_t s = starts[i];
  uint32_t w[9];
  if (s >= 0 && s <= len - PREFIX) {
    const uintptr_t a = (uintptr_t)(blob + s);
    const uint4* base = (const uint4*)(a & ~(uintptr_t)15);
    uint4 v[4];
    v[0] = __ldg(base);
    v[1] = __ldg(base + 1);
    v[2] = __ldg(base + 2);
    v[3] = (a & 15) > 16 * 3 - PREFIX ? __ldg(base + 3)
                                      : make_uint4(0, 0, 0, 0);
    window_words(v, (unsigned)(a & 15), w);
  } else {
#pragma unroll
    for (int k = 0; k < 9; k++) w[k] = load_u32(blob, len, s + 4 * k);
  }
  const int32_t f[N_FIELDS] = {
      (int32_t)w[0],                  // block_size
      (int32_t)w[1],                  // refid
      (int32_t)w[2],                  // pos
      (int32_t)(w[3] & 0xFF),         // l_read_name
      (int32_t)((w[3] >> 8) & 0xFF),  // mapq
      (int32_t)(w[3] >> 16),          // bin (unsigned shift)
      (int32_t)(w[4] & 0xFFFF),       // n_cigar
      (int32_t)(w[4] >> 16),          // flag (unsigned shift)
      (int32_t)w[5],                  // l_seq
      (int32_t)w[6],                  // next_refid
      (int32_t)w[7],                  // next_pos
      (int32_t)w[8],                  // tlen
  };
#pragma unroll
  for (int k = 0; k < N_FIELDS; k++) out[(int64_t)k * n + i] = f[k];
}

static int64_t parse_blocks(int64_t n) {
  return (n + PARSE_TPB - 1) / PARSE_TPB;
}

extern "C" int disq_parse_launch(const void* blob, int64_t len,
                                 const void* starts, int64_t n, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  parse_kernel<<<(unsigned)parse_blocks(n), PARSE_TPB, 0,
                 (cudaStream_t)stream>>>(
      (const uint8_t*)blob, len, (const int64_t*)starts, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Launch geometry for n records: threads per block, records per block,
// shared memory per block in bytes, and blocks.
extern "C" void disq_parse_geometry(int64_t n, int64_t* g) {
  g[0] = PARSE_TPB;
  g[1] = PARSE_TPB;
  g[2] = 0;
  g[3] = parse_blocks(n);
}
