// Raw-DEFLATE (RFC 1951) decode of BGZF payloads, one payload per thread.
//
// Replaces disq_tpu/ops/inflate_simd.py:_inflate_simd_kernel, the
// 128-lane Pallas decoder, and computes what it computes, with its status
// codes (0 ok, 1 bad BTYPE, 2 stored LEN mismatch, 3 bad Huffman code,
// 4 bad distance, 5 output overflow, 6 input overrun, 7 code-length repeat
// overflow, 8 ISIZE mismatch) and its decoding rules: bit-serial canonical
// Huffman decode with no completeness check on the code set, bits past
// the payload read as zero, overrun once more than 8 bytes past the end
// are consumed, distances over the bytes written or over 32 KiB rejected.
// The step granularity and fault precedence match the plain version,
// inflate_raw in disq_tpu_torch/ops/inflate_simd.py, line for line.
//
// What bounds it on this card: DEFLATE is bit-serial within a stream, so
// one block is a chain of dependent loads and branches — latency, not
// bytes or operations. The bytes it must move (compressed in, decoded
// out) would take well under a millisecond per split at 3.35 TB/s.
//
// What the design does about it: parallelism comes from blocks, one
// thread each (a split holds thousands), instead of the TPU kernel's
// one-hot lane gathers, which worked around Mosaic having no per-lane
// gathers. Each thread keeps its canonical tables (counts and sorted
// symbols, puff-style) in its own slice of shared memory, laid out
// thread-minor so a warp's table reads hit distinct banks; it keeps a
// 64-bit bit buffer in registers, writes each decoded byte straight to
// the block's final offset in the shard blob (known from the ISIZE
// prefix sum), and reads LZ77 history back from that same region, since
// BGZF blocks share no history. Latency is hidden only by the number of
// resident threads; a warp-cooperative decoder is later work.

#include <cstdint>
#include <cuda_runtime.h>

#define TPB 32
#define NLIT 288
#define NDIST 32
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

// Per-thread state in shared memory, indexed [entry][thread].
struct Smem {
  uint8_t lens[NLENS][TPB];
  uint8_t cl_lens[19][TPB];
  uint16_t lit_sym[NLIT][TPB];
  uint16_t dist_sym[NDIST][TPB];
  uint8_t cl_sym[19][TPB];
  uint16_t lit_cnt[16][TPB];
  uint16_t dist_cnt[16][TPB];
  uint16_t cl_cnt[8][TPB];
};

// LSB-first bit reader; bytes at or past the payload end read as zero.
struct Bits {
  const uint8_t* p;
  int64_t len;
  int64_t next;      // next byte to load
  int64_t pos;       // bits consumed
  uint64_t buf;
  int cnt;           // valid bits in buf

  __device__ void refill() {
    while (cnt <= 56) {
      uint64_t b = next < len ? p[next] : 0;
      buf |= b << cnt;
      next++;
      cnt += 8;
    }
  }
  __device__ uint32_t peek(int n) {
    refill();
    return (uint32_t)(buf & ((1ull << n) - 1));
  }
  __device__ void drop(int n) {
    refill();
    buf >>= n;
    cnt -= n;
    pos += n;
  }
  __device__ uint32_t take(int n) {
    uint32_t v = n ? peek(n) : 0;
    drop(n);
    return v;
  }
};

// Canonical code over lens[lo, lo+n): per-length counts and the
// (length, symbol)-sorted symbol list (puff's construct, no check).
template <typename Sym>
__device__ void build(uint8_t (*lens)[TPB], int lo, int n,
                      uint16_t (*cnt)[TPB], Sym (*sym)[TPB], int maxbits,
                      int t) {
  for (int l = 0; l <= maxbits; l++) cnt[l][t] = 0;
  for (int s = 0; s < n; s++) cnt[lens[lo + s][t]][t]++;
  int offs[16];
  offs[1] = 0;
  for (int l = 1; l < maxbits; l++) offs[l + 1] = offs[l] + cnt[l][t];
  for (int s = 0; s < n; s++) {
    int l = lens[lo + s][t];
    if (l) sym[offs[l]++][t] = (Sym)s;
  }
}

// Bit-serial canonical decode: the symbol, with its code length in
// *nbits, or -1 when no code of up to maxbits bits matches.
template <typename Sym>
__device__ int decode(Bits& bits, uint16_t (*cnt)[TPB],
                      Sym (*sym)[TPB], int maxbits, int t,
                      int* nbits) {
  uint32_t v = bits.peek(maxbits);
  uint32_t code = 0, first = 0, index = 0;
  for (int l = 1; l <= maxbits; l++) {
    code |= (v >> (l - 1)) & 1u;
    uint32_t count = cnt[l][t];
    if (code - first < count) {  // unsigned: code below first never hits
      *nbits = l;
      return sym[index + code - first][t];
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  *nbits = 0;
  return -1;
}

struct Out {
  uint8_t* p;
  int64_t n;    // bytes written
  int64_t cap;  // this block's ISIZE
};

__device__ int stored(Bits& bits, Out& out, int64_t limit) {
  uint32_t length = bits.take(16);
  if (bits.pos > limit) return ST_IN_OVERRUN;
  uint32_t nlen = bits.take(16);
  if (bits.pos > limit) return ST_IN_OVERRUN;
  if ((nlen ^ 0xFFFFu) != length) return ST_BAD_STORED;
  while (length) {
    uint32_t k = 4 - (uint32_t)(out.n & 3);
    if (k > length) k = length;
    uint32_t chunk = bits.take(8 * k);
    length -= k;
    for (uint32_t j = 0; j < k; j++) {
      if (out.n >= out.cap)
        return bits.pos > limit ? ST_IN_OVERRUN : ST_OUT_OVERFLOW;
      out.p[out.n++] = (uint8_t)(chunk >> (8 * j));
    }
    if (bits.pos > limit) return ST_IN_OVERRUN;
  }
  return ST_OK;
}

// Read a dynamic block's code tables into the lit/dist tables.
__device__ int dynamic_tables(Bits& bits, Smem& s, int64_t limit, int t) {
  uint32_t v = bits.take(14);
  if (bits.pos > limit) return ST_IN_OVERRUN;
  int hlit = (v & 31) + 257, hdist = ((v >> 5) & 31) + 1;
  int hclen = ((v >> 10) & 15) + 4;
  for (int i = 0; i < 19; i++) s.cl_lens[i][t] = 0;
  for (int i = 0; i < NLENS; i++) s.lens[i][t] = 0;
  for (int i = 0; i < hclen; i++) {
    s.cl_lens[c_clorder[i]][t] = (uint8_t)bits.take(3);
    if (bits.pos > limit) return ST_IN_OVERRUN;
  }
  build<uint8_t>(s.cl_lens, 0, 19, s.cl_cnt, s.cl_sym, 7, t);
  int total = hlit + hdist, nread = 0, prev = 0;
  while (nread < total) {
    int nb;
    int sym = decode<uint8_t>(bits, s.cl_cnt, s.cl_sym, 7, t, &nb);
    if (sym < 0) return ST_BAD_CODE;
    bits.drop(nb);
    if (sym <= 15) {
      s.lens[nread++][t] = (uint8_t)sym;
      prev = sym;
      if (bits.pos > limit) return ST_IN_OVERRUN;
      continue;
    }
    int rep, val;
    if (sym == 16) {
      rep = 3 + (int)bits.take(2);
      val = prev;
    } else if (sym == 17) {
      rep = 3 + (int)bits.take(3);
      val = 0;
    } else {
      rep = 11 + (int)bits.take(7);
      val = 0;
    }
    if (bits.pos > limit) return ST_IN_OVERRUN;
    if (sym == 16 && nread == 0) return ST_REPEAT_OVERFLOW;
    for (int r = 0; r < rep; r++) {
      if (nread >= total) return ST_REPEAT_OVERFLOW;
      s.lens[nread++][t] = (uint8_t)val;
      prev = val;
    }
  }
  build<uint16_t>(s.lens, 0, hlit, s.lit_cnt, s.lit_sym, 15, t);
  build<uint16_t>(s.lens, hlit, hdist, s.dist_cnt, s.dist_sym, 15, t);
  return ST_OK;
}

__device__ void fixed_tables(Smem& s, int t) {
  for (int i = 0; i < NLENS; i++) {
    uint8_t l = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < NLIT ? 8 : 5;
    s.lens[i][t] = l;
  }
  build<uint16_t>(s.lens, 0, NLIT, s.lit_cnt, s.lit_sym, 15, t);
  build<uint16_t>(s.lens, NLIT, NDIST, s.dist_cnt, s.dist_sym, 15, t);
}

// Literal/length and distance symbols up to end-of-block.
__device__ int codes(Bits& bits, Out& out, Smem& s, int64_t limit, int t) {
  for (;;) {
    int nb;
    int sym = decode<uint16_t>(bits, s.lit_cnt, s.lit_sym, 15, t, &nb);
    if (sym < 0) return ST_BAD_CODE;
    bits.drop(nb);
    if (sym < 256) {
      if (out.n >= out.cap)
        return bits.pos > limit ? ST_IN_OVERRUN : ST_OUT_OVERFLOW;
      out.p[out.n++] = (uint8_t)sym;
      if (bits.pos > limit) return ST_IN_OVERRUN;
      continue;
    }
    if (sym == 256) return bits.pos > limit ? ST_IN_OVERRUN : ST_OK;
    if (sym > 285) return bits.pos > limit ? ST_IN_OVERRUN : ST_BAD_CODE;
    int li = sym - 257;
    int length = c_lbase[li] + (int)bits.take(c_lext[li]);
    if (bits.pos > limit) return ST_IN_OVERRUN;
    int dsym = decode<uint16_t>(bits, s.dist_cnt, s.dist_sym, 15, t, &nb);
    if (dsym < 0) return ST_BAD_CODE;
    bits.drop(nb);
    if (dsym > 29) return bits.pos > limit ? ST_IN_OVERRUN : ST_BAD_CODE;
    int64_t d = c_dbase[dsym] + (int64_t)bits.take(c_dext[dsym]);
    if (bits.pos > limit) return ST_IN_OVERRUN;
    if (d > out.n || d > 32768) return ST_BAD_DIST;
    for (int k = 0; k < length; k++) {
      if (out.n >= out.cap) return ST_OUT_OVERFLOW;
      out.p[out.n] = out.p[out.n - d];
      out.n++;
    }
  }
}

__device__ int inflate_stream(Bits& bits, Out& out, Smem& s, int64_t limit,
                              int t) {
  for (;;) {
    uint32_t hdr = bits.take(3);
    uint32_t bfinal = hdr & 1, btype = hdr >> 1;
    if (btype == 0) bits.drop((int)((-bits.pos) & 7));
    if (bits.pos > limit) return ST_IN_OVERRUN;
    if (btype == 3) return ST_BAD_BTYPE;
    int st;
    if (btype == 0) {
      st = stored(bits, out, limit);
    } else {
      if (btype == 1) {
        fixed_tables(s, t);
      } else {
        st = dynamic_tables(bits, s, limit, t);
        if (st != ST_OK) return st;
      }
      st = codes(bits, out, s, limit, t);
    }
    if (st != ST_OK) return st;
    if (bfinal) return ST_OK;
  }
}

__global__ void __launch_bounds__(TPB)
inflate_kernel(const uint8_t* __restrict__ comp,
               const int64_t* __restrict__ pay_off,
               const int64_t* __restrict__ pay_len,
               const int64_t* __restrict__ out_off, uint8_t* out,
               int32_t* __restrict__ out_len, int32_t* __restrict__ status,
               int64_t n) {
  __shared__ Smem s;
  int t = threadIdx.x;
  int64_t i = (int64_t)blockIdx.x * TPB + t;
  if (i >= n) return;
  int64_t clen = pay_len[i];
  Bits bits{comp + pay_off[i], clen, 0, 0, 0ull, 0};
  Out o{out + out_off[i], 0, out_off[i + 1] - out_off[i]};
  int st = ST_OK;
  if (clen > 0) st = inflate_stream(bits, o, s, (clen + 8) * 8, t);
  if (st == ST_OK && o.n != o.cap) st = ST_ISIZE_MISMATCH;
  out_len[i] = (int32_t)o.n;
  status[i] = st;
}

extern "C" int disq_inflate_launch(const void* comp, const void* pay_off,
                                   const void* pay_len, const void* out_off,
                                   void* out, void* out_len, void* status,
                                   int64_t n, void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + TPB - 1) / TPB);
  inflate_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int64_t*)pay_off, (const int64_t*)pay_len,
      (const int64_t*)out_off, (uint8_t*)out, (int32_t*)out_len,
      (int32_t*)status, n);
  return (int)cudaGetLastError();
}
