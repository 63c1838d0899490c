// Raw-DEFLATE (RFC 1951) decode, one payload per thread block (kernel B4).
//
// Replaces disq_tpu/ops/inflate.py:_inflate_kernel, the round-1 Pallas
// decoder that runs one BGZF payload per grid program, and computes what it
// computes: row i of a (B, 65536) uint8 slab and meta[i] = [len, status],
// with its status codes (0 ok, 1 bad BTYPE, 2 stored LEN mismatch, 3 bad
// Huffman code, 4 invalid distance, 5 output overflow, 6 ran past the
// payload, 7 code-length repeat overflow, 8 ISIZE mismatch) and its rules,
// which are not B1's (csrc/inflate.cu): bytes past the payload read as zero
// and the stream has overrun as soon as its bit cursor passes csize * 8;
// every alphabet decodes bit by bit up to 15 bits; a distance symbol over 29
// or a distance past the bytes written is 4 (no 32 KiB window check); a
// stored block crossing the payload end is 6 and copies nothing; a dynamic
// block whose code lengths fail still decodes its data; usize -1 skips the
// ISIZE check. The step order and fault precedence follow the plain
// version, _Stream in disq_tpu_torch/ops/inflate.py, line for line.
//
// What bounds it on this card: DEFLATE is bit-serial within a stream, so
// the decode of one payload is a chain of dependent shared-memory loads and
// branches — latency, not bytes or operations. The bytes it must move
// (compressed in, 65,536 per row out) take well under a millisecond per
// split at 3.35 TB/s.
//
// What the design does about it: one thread block per payload, as the TPU
// kernel had one grid program. The block's threads stage the payload
// (zero-padded to 66,560 bytes) and a zeroed output row in dynamic shared
// memory, and build each canonical table (per-length counts, first codes,
// offsets, symbols sorted by length) together; one thread then decodes,
// reading its bits and its LZ77 history from shared memory only; at the end
// the threads copy the row out in 16-byte stores. The TPU kernel's (8, 128)
// tile loads with one-hot selects, which worked around Mosaic's aligned
// dynamic access, are not carried over. The ~135 KB of shared memory allows
// one block per SM, so 132 payloads decode at a time: simple and right
// first; a faster decoder is later work.

#include <cstdint>
#include <cuda_runtime.h>

#define TPB 256
#define CMAX 66560
#define UMAX 65536
#define NLIT 288
#define NDIST 32
#define NCL 19
#define NLENS (NLIT + NDIST)

enum {
  ST_OK = 0, ST_BAD_BTYPE = 1, ST_BAD_STORED = 2, ST_BAD_CODE = 3,
  ST_BAD_DIST = 4, ST_OUT_OVERFLOW = 5, ST_IN_OVERRUN = 6,
  ST_REPEAT_OVERFLOW = 7, ST_ISIZE_MISMATCH = 8
};

__constant__ uint16_t c_lbase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
    59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t c_lext[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
    4, 5, 5, 5, 5, 0};
__constant__ uint16_t c_dbase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
    513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
    24577};
__constant__ uint8_t c_dext[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
    10, 11, 11, 12, 12, 13, 13};
__constant__ uint8_t c_clorder[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// Canonical tables, rows 0 = code-length, 1 = literal/length, 2 = distance.
struct Tables {
  int16_t lens[NLENS];
  int32_t cnt[3][16];
  int32_t first[3][16];
  int32_t off[3][16];
  int16_t syms[3][NLIT];
};

// Decode state shared by the block between the cooperative steps.
struct State {
  int bp, op, err, fin, btype, hlit, hdist;
};

__device__ __forceinline__ uint32_t byte_at(const uint8_t* c, int i) {
  return i < CMAX ? (uint32_t)c[i] : 0u;  // zero past csize by staging
}

// n <= 16 bits at bit cursor bp, least significant first.
__device__ __forceinline__ int get_bits(const uint8_t* c, int bp, int n) {
  const int i = bp >> 3;
  const uint32_t v = byte_at(c, i) | (byte_at(c, i + 1) << 8) |
                     (byte_at(c, i + 2) << 16);
  return (int)((v >> (bp & 7)) & ((1u << n) - 1u));
}

// The reference's bit-by-bit canonical walk. Returns the new cursor; sym
// and err as the plain version's _Stream.symbol: status 6 at the first bit
// past the limit (with the symbol when that bit completes one), 3 after 15
// bits without a match.
__device__ __forceinline__ int decode_sym(const Tables& T, int a,
                                          const uint8_t* c, int bp, int limit,
                                          int& sym, int& err) {
  int over = limit - bp + 1;
  if (over < 1) over = 1;
  const int v = get_bits(c, bp, 15);
  int code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code << 1) | ((v >> (l - 1)) & 1);
    const int idx = code - T.first[a][l];
    const bool hit = idx >= 0 && idx < T.cnt[a][l];
    if (l >= over) {
      sym = hit ? T.syms[a][T.off[a][l] + idx] : 0;
      err = ST_IN_OVERRUN;
      return bp + l;
    }
    if (hit) {
      sym = T.syms[a][T.off[a][l] + idx];
      err = ST_OK;
      return bp + l;
    }
  }
  sym = 0;
  err = ST_BAD_CODE;
  return bp + 15;
}

// All threads: the canonical table of alphabet a over lens[base, base+nsym).
__device__ void build_table(Tables& T, int a, int base, int nsym, int t) {
  if (t < 16) T.cnt[a][t] = 0;
  __syncthreads();
  for (int s = t; s < nsym; s += TPB) {
    const int l = T.lens[base + s];
    if (l > 0) atomicAdd(&T.cnt[a][l], 1);
  }
  __syncthreads();
  if (t == 0) {
    int code = 0, acc = 0;
    T.first[a][0] = 0;
    T.off[a][0] = 0;
    for (int l = 1; l < 16; l++) {
      code = (code + T.cnt[a][l - 1]) * 2;
      acc += T.cnt[a][l - 1];
      T.first[a][l] = code;
      T.off[a][l] = acc;
    }
  }
  __syncthreads();
  for (int s = t; s < nsym; s += TPB) {  // rank within its length
    const int l = T.lens[base + s];
    if (l > 0) {
      int r = 0;
      for (int u = 0; u < s; u++) r += T.lens[base + u] == l;
      T.syms[a][T.off[a][l] + r] = (int16_t)s;
    }
  }
  __syncthreads();
}

// One thread: literal/match loop up to end-of-block. Returns its status.
__device__ int run_data(const Tables& T, const uint8_t* c, uint8_t* o,
                        int limit, int& bp, int& op) {
  while (true) {
    int sym, err;
    bp = decode_sym(T, 1, c, bp, limit, sym, err);
    if (err == ST_OK && sym < 256) {
      if (op < UMAX) o[op++] = (uint8_t)sym;
      else err = ST_OUT_OVERFLOW;
    } else if (err == ST_OK && sym > 256) {
      int li = sym - 257;
      if (li > 28) {
        err = ST_BAD_CODE;
        li = 28;
      }
      const int length = c_lbase[li] + get_bits(c, bp, c_lext[li]);
      bp += c_lext[li];
      int dsym, derr;
      bp = decode_sym(T, 2, c, bp, limit, dsym, derr);
      if (err == ST_OK && derr) err = derr;
      if (err == ST_OK && dsym > 29) err = ST_BAD_DIST;
      if (dsym > 29) dsym = 29;
      const int d = c_dbase[dsym] + get_bits(c, bp, c_dext[dsym]);
      bp += c_dext[dsym];
      if (err == ST_OK && d > op) err = ST_BAD_DIST;
      if (err == ST_OK && op + length > UMAX) err = ST_OUT_OVERFLOW;
      if (err == ST_OK) {
        for (int k = 0; k < length; k++) o[op + k] = o[op + k - d];
        op += length;
      }
    }
    if (err == ST_OK && bp > limit) err = ST_IN_OVERRUN;
    if (sym == 256 || err) return err;
  }
}

// One thread: a stored block after its 3 header bits.
__device__ void stored_block(const uint8_t* c, uint8_t* o, int limit,
                             State& S) {
  int bp = (S.bp + 7) & ~7;
  const int blen = get_bits(c, bp, 16);
  const int nlen = get_bits(c, bp + 16, 16);
  bp += 32;
  if ((blen ^ 0xFFFF) != nlen) {
    S.err = ST_BAD_STORED;
  } else if (S.op + blen > UMAX) {
    S.err = ST_OUT_OVERFLOW;
  } else if (bp + blen * 8 > limit) {
    S.err = ST_IN_OVERRUN;
  } else {
    const int src = bp >> 3;
    for (int k = 0; k < blen; k++) o[S.op + k] = c[src + k];
    S.op += blen;
    bp += blen * 8;
  }
  S.bp = bp;
}

// One thread: a dynamic block's code lengths, after build_table(0).
__device__ void dynamic_lengths(Tables& T, const uint8_t* c, int limit,
                                State& S) {
  for (int i = 0; i < NCL; i++) T.lens[i] = 0;
  const int hlit = S.hlit, hdist = S.hdist, total = hlit + hdist;
  int bp = S.bp, n = 0, err = ST_OK;
  while (n < total && err == ST_OK) {
    int sym;
    bp = decode_sym(T, 0, c, bp, limit, sym, err);
    int rep = 1;
    if (sym == 16) {
      rep = 3 + get_bits(c, bp, 2);
      bp += 2;
    } else if (sym == 17) {
      rep = 3 + get_bits(c, bp, 3);
      bp += 3;
    } else if (sym == 18) {
      rep = 11 + get_bits(c, bp, 7);
      bp += 7;
    }
    const int prev = T.lens[n > 0 ? n - 1 : 0];
    if (sym == 16 && n == 0) err = ST_REPEAT_OVERFLOW;
    const int val = sym < 16 ? sym : (sym == 16 ? prev : 0);
    const int count = sym < 16 ? 1 : rep;
    if (err == ST_OK && n + count > total) err = ST_REPEAT_OVERFLOW;
    if (err == ST_OK) {
      for (int k = 0; k < count; k++) T.lens[n + k] = (int16_t)val;
      n += count;
    }
  }
  // distance lengths to their fixed base, backward (dst >= src), then
  // clear the literal tail
  for (int k = 0; k < NDIST; k++) {
    const int i = NDIST - 1 - k;
    const int src = hlit + i < NLENS - 1 ? hlit + i : NLENS - 1;
    T.lens[NLIT + i] = i < hdist ? T.lens[src] : 0;
  }
  for (int i = hlit; i < NLIT; i++) T.lens[i] = 0;
  S.bp = bp;
  S.err = err;
}

__global__ void __launch_bounds__(TPB) inflate_legacy_kernel(
    const uint8_t* __restrict__ comp, const int64_t* __restrict__ pay_off,
    const int32_t* __restrict__ csizes, const int32_t* __restrict__ usizes,
    uint8_t* __restrict__ out, int32_t* __restrict__ meta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* cbuf = smem;         // the payload, zero past csize
  uint8_t* obuf = smem + CMAX;  // the output row
  __shared__ Tables T;
  __shared__ State S;
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int csize = csizes[b];
  const int limit = csize * 8;
  const uint8_t* src = comp + pay_off[b];
  for (int k = t; k < CMAX; k += TPB) cbuf[k] = k < csize ? src[k] : 0;
  uint4* o4 = reinterpret_cast<uint4*>(obuf);
  for (int k = t; k < UMAX / 16; k += TPB) o4[k] = make_uint4(0, 0, 0, 0);
  if (t == 0) {
    S.bp = 0;
    S.op = 0;
    S.err = ST_OK;
    S.fin = 0;
  }
  __syncthreads();

  while (true) {  // one DEFLATE block per turn; S is block-uniform at syncs
    if (t == 0) {
      const int hdr = get_bits(cbuf, S.bp, 3);
      S.bp += 3;
      S.fin = hdr & 1;
      S.btype = hdr >> 1;
      if (S.btype == 0) {
        stored_block(cbuf, obuf, limit, S);
      } else if (S.btype == 1) {
        for (int i = 0; i < NLENS; i++)
          T.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
      } else if (S.btype == 2) {
        S.hlit = get_bits(cbuf, S.bp, 5) + 257;
        S.hdist = get_bits(cbuf, S.bp + 5, 5) + 1;
        const int hclen = get_bits(cbuf, S.bp + 10, 4) + 4;
        S.bp += 14;
        for (int i = 0; i < NLENS; i++) T.lens[i] = 0;
        for (int i = 0; i < hclen; i++) {
          T.lens[c_clorder[i]] = (int16_t)get_bits(cbuf, S.bp, 3);
          S.bp += 3;
        }
      } else {
        S.err = ST_BAD_BTYPE;
      }
    }
    __syncthreads();
    const int btype = S.btype;
    if (btype == 2) {
      build_table(T, 0, 0, NCL, t);
      if (t == 0) dynamic_lengths(T, cbuf, limit, S);
      __syncthreads();
    }
    if (btype == 1 || btype == 2) {
      build_table(T, 1, 0, NLIT, t);
      build_table(T, 2, NLIT, NDIST, t);
      if (t == 0) {
        int bp = S.bp, op = S.op;
        const int derr = run_data(T, cbuf, obuf, limit, bp, op);
        S.bp = bp;
        S.op = op;
        if (S.err == ST_OK) S.err = derr;
      }
    }
    if (t == 0 && S.err == ST_OK && S.bp > limit) S.err = ST_IN_OVERRUN;
    __syncthreads();
    const bool stop = S.fin || S.err;
    __syncthreads();  // every thread has read S before thread 0 moves on
    if (stop) break;
  }

  if (t == 0) {
    const int usize = usizes[b];
    int err = S.err;
    if (err == ST_OK && usize >= 0 && S.op != usize) err = ST_ISIZE_MISMATCH;
    meta[2 * b] = S.op;
    meta[2 * b + 1] = err;
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * UMAX);
  for (int k = t; k < UMAX / 16; k += TPB) dst[k] = o4[k];
}

extern "C" int disq_inflate_legacy_launch(const void* comp, const void* pay_off,
                                          const void* csizes,
                                          const void* usizes, void* out,
                                          void* meta, int64_t n,
                                          void* stream) {
  if (n <= 0) return 0;
  const int smem = CMAX + UMAX;
  cudaError_t e = cudaFuncSetAttribute(
      inflate_legacy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  inflate_legacy_kernel<<<(unsigned)n, TPB, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int64_t*)pay_off, (const int32_t*)csizes,
      (const int32_t*)usizes, (uint8_t*)out, (int32_t*)meta);
  return (int)cudaGetLastError();
}
