// Raw-DEFLATE (RFC 1951) decode of BGZF payloads, one warp per payload.
//
// Replaces disq_tpu/ops/inflate_simd.py:_inflate_simd_kernel (kernel B1), the
// 128-lane Pallas decoder, and computes what it computes, with its status
// codes (0 ok, 1 bad BTYPE, 2 stored LEN mismatch, 3 bad Huffman code,
// 4 bad distance, 5 output overflow, 6 input overrun, 7 code-length repeat
// overflow, 8 ISIZE mismatch) and its decoding rules: canonical Huffman
// decode with no completeness check on the code set (an over-subscribed set
// decodes by the walk's first match), bits past the payload read as zero,
// overrun once more than 8 bytes past the end are consumed, distances over
// the bytes written or over 32 KiB rejected. Each status is decided after
// the same step as in the plain version, inflate_raw in
// disq_tpu_torch/ops/inflate_simd.py, which defines the function, and a
// flagged payload has written exactly the bytes that version writes.
//
// What bounds it on this card: DEFLATE is bit-serial within a payload, so a
// payload is one chain of dependent table reads and branches -- latency,
// not bytes or operations (the bytes a split must move take well under a
// millisecond at 3.35 TB/s). Parallelism comes from the payloads: a 64 MiB
// split holds ~1,830 of them, and the design keeps them all in flight at
// once with short links in each chain:
//
// - One warp per payload, WARPS warps per block: a split is one wave of
//   ~14 warps on every SM, which hide each other's latency. The 32 lanes
//   run the symbol decode in lockstep on the same values (their
//   shared-memory and input reads are broadcasts, a literal's byte is
//   stored by every lane), so no branch depends on the lane; the lanes
//   split what is parallel: table builds, match copies, stored copies.
// - Table-driven Huffman decode. Each warp builds a 2^LW-entry lit/len and
//   a 2^DW-entry distance table in its shared memory, every entry filled by
//   evaluating the canonical walk on that bit pattern: (symbol, length,
//   extra bits, base), or "no match within the width". So for every code
//   set -- complete, incomplete or over-subscribed -- a table hit is what
//   the walk gives; a miss continues with the full walk (codes longer than
//   the width, or none). The fixed tables are built once per block.
// - Runs of literals decode in a loop with no per-symbol status test: a
//   run is cut to the bytes of room and the bits before the overrun limit
//   that no literal of it can cross.
// - A 64-bit bit buffer refilled 32 bits at a time from aligned words
//   loaded one refill ahead; bytes at and past the payload's end are
//   masked to zero (the blob goes on with the BGZF footer and the next
//   block).
// - Warp-cooperative copies. For a match of length L at distance d, lane k
//   writes out[n+k] = out[n-d+(k mod d)], 32 bytes a step: every source
//   lies before n, so overlapping matches need no ordering between steps.
//   Stored blocks copy in parallel, cut where the serial chunk loop stops.
// - History is the block's final row in the output blob: each byte is
//   written once at its final offset (known from the ISIZE prefix sum) and
//   matches read their sources back from there, so any ISIZE, however
//   large, decodes the same way. The sources were just written by the same
//   warp and come back through L1/L2, so a warp's shared memory holds only
//   its tables (~6.6 KB) and a block of 4 warps stays under the 48 KB a
//   launch may take without opting in.

#include <cstdint>
#include <cuda_runtime.h>

#define WARPS 4        // payloads (warps) per block
#define LW 10          // lit/len table width, bits
#define DW 8           // distance table width, bits
#define CW 7           // code-length table width (its longest code)
#define NLIT 288
#define NDIST 32
#define NLENS (NLIT + NDIST)
#define FULL 0xFFFFFFFFu
#define LITERAL 0x80000000u  // the entry flag of a literal

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

// A table entry: code length (bits 0-3, 0 = no match within the width),
// symbol (4-12), extra-bit count (13-16) and base (17-31) of a length or
// distance symbol; a literal's entry has bit 31 set (its base is 0).
enum Kind { KIND_LIT, KIND_DIST, KIND_CL };

__device__ __forceinline__ uint32_t make_entry(uint32_t sym, uint32_t nb,
                                               Kind kind) {
  uint32_t ext = 0, base = 0;
  if (kind == KIND_LIT && sym >= 257 && sym <= 285) {
    ext = c_lext[sym - 257];
    base = c_lbase[sym - 257];
  } else if (kind == KIND_DIST && sym <= 29) {
    ext = c_dext[sym];
    base = c_dbase[sym];
  } else if (kind == KIND_LIT && sym < 256) {
    base = LITERAL >> 17;
  }
  return nb | sym << 4 | ext << 13 | base << 17;
}

// One canonical code: per-length counts and the (length, symbol)-sorted
// symbols (puff's construct, no completeness check), and its table.
struct Code {
  const uint32_t* tab;
  const uint16_t* cnt;
  const uint16_t* sym;
};

struct WarpSmem {
  uint32_t lit[1 << LW];
  uint32_t dist[1 << DW];
  uint32_t cl[1 << CW];
  uint16_t lit_sym[NLIT];
  uint16_t dist_sym[NDIST];
  uint16_t cl_sym[20];
  uint16_t lit_cnt[16];
  uint16_t dist_cnt[16];
  uint16_t cl_cnt[16];
  uint16_t run[16];
  uint8_t lens[NLENS];
  uint8_t cl_lens[20];
};

struct FixedSmem {
  uint32_t lit[1 << LW];
  uint32_t dist[1 << DW];
  uint16_t lit_sym[NLIT];
  uint16_t dist_sym[NDIST];
  uint16_t lit_cnt[16];
  uint16_t dist_cnt[16];
};

// Counts and sorted symbols of the code over lens[0, n), by the warp.
__device__ void construct(const uint8_t* lens, int n, uint16_t* cnt,
                          uint16_t* sym, uint16_t* run, int lane) {
  if (lane < 16) cnt[lane] = 0;
  __syncwarp();
  for (int b = 0; b < n; b += 32) {
    int s = b + lane;
    unsigned l = s < n ? lens[s] : 16u;
    unsigned m = __match_any_sync(FULL, l);
    if (l >= 1 && l < 16 && lane == __ffs(m) - 1) cnt[l] += __popc(m);
    __syncwarp();
  }
  if (lane >= 1 && lane < 16) {  // offs[l]: symbols of shorter codes
    uint32_t o = 0;
    for (int j = 1; j < lane; j++) o += cnt[j];
    run[lane] = (uint16_t)o;
  }
  __syncwarp();
  for (int b = 0; b < n; b += 32) {
    int s = b + lane;
    unsigned l = s < n ? lens[s] : 16u;
    unsigned m = __match_any_sync(FULL, l);
    bool live = l >= 1 && l < 16;
    uint32_t at = live ? run[l] + __popc(m & ((1u << lane) - 1)) : 0;
    __syncwarp();
    if (live) {
      sym[at] = (uint16_t)s;
      if (lane == __ffs(m) - 1) run[l] += __popc(m);
    }
    __syncwarp();
  }
}

// The canonical walk on the low maxbits bits of v: the entry of the first
// match, or 0 when no code of up to maxbits bits matches.
__device__ __forceinline__ uint32_t walk(uint32_t v, const uint16_t* cnt,
                                         const uint16_t* sym, int maxbits,
                                         Kind kind) {
  uint32_t code = 0, first = 0, index = 0;
  for (int l = 1; l <= maxbits; l++) {
    code |= (v >> (l - 1)) & 1u;
    uint32_t count = cnt[l];
    if (code - first < count)  // unsigned: code below first never hits
      return make_entry(sym[index + code - first], l, kind);
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return 0;
}

// Every W-bit pattern's entry: the walk cut at W levels.
template <int W>
__device__ void fill_table(uint32_t* tab, const uint16_t* cnt,
                           const uint16_t* sym, Kind kind, int lane) {
  for (uint32_t v = lane; v < (1u << W); v += 32)
    tab[v] = walk(v, cnt, sym, W, kind);
  __syncwarp();
}

// LSB-first bit reader over one payload, refilled 32 bits at a time from
// aligned words; bytes at or past the payload's end read as zero. Each
// word is loaded one refill ahead and masked when it is consumed, so a
// refill waits on no load issued in it.
struct Bits {
  const uint32_t* w;   // aligned words: w[k] holds bytes [4k-head, 4k-head+4)
  int64_t len;         // payload bytes
  int64_t head;        // the payload's offset in its first word
  int64_t nxt;         // index of the word in `pre`
  uint32_t pre;        // word nxt, loaded one refill ahead (0 past the end)
  uint32_t keep;       // the mask of its payload bytes
  uint64_t buf;
  int cnt;             // valid bits in buf
  int64_t pos;         // bits consumed

  // word k, and the mask of its bytes below the payload's end
  __device__ __forceinline__ void load(int64_t k, uint32_t& v,
                                       uint32_t& m) const {
    const int64_t valid = len - (4 * k - head);
    v = valid > 0 ? __ldg(w + k) : 0u;
    m = valid >= 4 ? 0xFFFFFFFFu : valid > 0 ? (1u << (8 * valid)) - 1 : 0u;
  }
  __device__ __forceinline__ void fill() {
    if (cnt <= 32) {
      buf |= (uint64_t)(pre & keep) << cnt;
      cnt += 32;
      load(++nxt, pre, keep);
    }
  }
  // restart at payload byte `byte` (pos = 8 * byte)
  __device__ void seek(int64_t byte) {
    const int64_t k = (byte + head) >> 2;
    const int sub = (int)((byte + head) & 3);
    uint32_t v, m;
    load(k, v, m);
    buf = (v & m) >> (8 * sub);
    cnt = 32 - 8 * sub;
    nxt = k + 1;
    load(nxt, pre, keep);
    pos = 8 * byte;
    fill();
  }
  __device__ __forceinline__ void drop(int n) {
    buf >>= n;
    cnt -= n;
    pos += n;
  }
  __device__ __forceinline__ uint32_t take(int n) {
    uint32_t v = (uint32_t)buf & ((1u << n) - 1);
    drop(n);
    return v;
  }
};

struct Out {
  uint8_t* p;     // the block's row in the blob
  int64_t n;      // bytes written
  int64_t cap;    // the block's ISIZE
};

// a mod d for a <= 32 and 1 <= d <= 258: the float quotient rounded toward
// zero is floor(a / d) or one less, fixed up once.
__device__ __forceinline__ uint32_t small_mod(uint32_t a, uint32_t d) {
  const uint32_t q =
      __float2uint_rz(__fmul_rz((float)a, __frcp_rz((float)d)));
  const uint32_t r = a - q * d;
  return r >= d ? r - d : r;
}

// out[n, n+L) from the history at distance d: lane k writes out[n+k] =
// out[n-d+(k mod d)], 32 bytes a step. Every source lies before n, so the
// steps need no ordering between them.
__device__ __forceinline__ void copy_match(Out& out, uint32_t d, uint32_t L,
                                           int lane) {
  __syncwarp();  // the lanes' earlier stores are visible to every lane
  // lane k's offset into the source: k itself when the source does not
  // overlap the copy (k < L <= d), else k mod d (the output repeats with
  // period d)
  uint32_t r = lane, step = 32;
  if (d < L) {
    r = small_mod(lane, d);
    step = small_mod(32, d);
  }
  const uint8_t* src = out.p + out.n - d;
  uint8_t* dst = out.p + out.n;
  for (uint32_t k = lane; k < L; k += 32) {
    dst[k] = src[r];
    r += step;
    if (r >= d) r -= d;
  }
  out.n += L;
}

__device__ int stored(Bits& bits, Out& out, int64_t limit,
                      const uint8_t* pay, int lane) {
  bits.fill();
  uint32_t length = bits.take(16);
  uint32_t nlen = bits.take(16);
  if (bits.pos > limit) return ST_IN_OVERRUN;  // after LEN or after NLEN
  if ((nlen ^ 0xFFFFu) != length) return ST_BAD_STORED;
  // The serial loop copies chunks up to the next 4-byte output boundary;
  // it stops at the first byte past the capacity (status 6 if that byte's
  // chunk ran more than 8 bytes past the payload, else 5), or after the
  // first chunk that ran past it (6). ce(j): end of the chunk holding
  // data byte j.
  const int64_t B = bits.pos >> 3;                 // pos is byte-aligned
  const int64_t room = bits.len + 8 - B;           // bytes before an overrun
  const int64_t len = length;
  const int64_t k0 = min(4 - (out.n & 3), len);
  auto ce = [&](int64_t j) {
    return j < k0 ? k0 : min(k0 + 4 * ((j - k0) / 4 + 1), len);
  };
  const int64_t jc = out.cap - out.n;
  const bool cap_hit = jc < len, over = room < len;
  int64_t w = len;
  int st = ST_OK;
  if (cap_hit && (!over || ce(jc) <= ce(room))) {
    w = jc;
    st = ce(jc) > room ? ST_IN_OVERRUN : ST_OUT_OVERFLOW;
  } else if (over) {
    w = ce(room);
    st = ST_IN_OVERRUN;
  }
  for (int64_t j = lane; j < w; j += 32)
    out.p[out.n + j] = B + j < bits.len ? pay[B + j] : 0;
  out.n += w;
  if (st != ST_OK) return st;
  bits.seek(B + len);
  return ST_OK;
}

// Read a dynamic block's code tables into the warp's lit/dist tables.
__device__ int dynamic_tables(Bits& bits, WarpSmem& s, int64_t limit,
                              int lane) {
  bits.fill();
  uint32_t v = bits.take(14);
  if (bits.pos > limit) return ST_IN_OVERRUN;
  int hlit = (v & 31) + 257, hdist = ((v >> 5) & 31) + 1;
  int hclen = ((v >> 10) & 15) + 4;
  if (lane < 20) s.cl_lens[lane] = 0;
  for (int j = lane; j < NLENS; j += 32) s.lens[j] = 0;
  __syncwarp();
  for (int j = 0; j < hclen; j++) {
    bits.fill();
    uint32_t l = bits.take(3);
    if (lane == 0) s.cl_lens[c_clorder[j]] = (uint8_t)l;
  }
  if (bits.pos > limit) return ST_IN_OVERRUN;  // after some length's 3 bits
  __syncwarp();
  construct(s.cl_lens, 19, s.cl_cnt, s.cl_sym, s.run, lane);
  fill_table<CW>(s.cl, s.cl_cnt, s.cl_sym, KIND_CL, lane);
  int total = hlit + hdist, nread = 0, prev = 0;
  while (nread < total) {
    bits.fill();
    uint32_t e = s.cl[bits.buf & ((1u << CW) - 1)];
    if (!(e & 15)) return ST_BAD_CODE;
    int sym = (e >> 4) & 511;
    bits.drop(e & 15);
    if (sym <= 15) {
      if (lane == 0) s.lens[nread] = (uint8_t)sym;
      nread++;
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
    int w = min(rep, total - nread);
    for (int j = lane; j < w; j += 32) s.lens[nread + j] = (uint8_t)val;
    nread += w;
    prev = val;
    if (w < rep) return ST_REPEAT_OVERFLOW;
  }
  __syncwarp();
  construct(s.lens, hlit, s.lit_cnt, s.lit_sym, s.run, lane);
  construct(s.lens + hlit, hdist, s.dist_cnt, s.dist_sym, s.run, lane);
  fill_table<LW>(s.lit, s.lit_cnt, s.lit_sym, KIND_LIT, lane);
  fill_table<DW>(s.dist, s.dist_cnt, s.dist_sym, KIND_DIST, lane);
  return ST_OK;
}

// Literal/length and distance symbols up to end-of-block.
__device__ int codes(Bits& bits, Out& out, const Code& lit, const Code& dist,
                     int64_t limit, int lane) {
  for (;;) {
    bits.fill();
    uint32_t e = lit.tab[bits.buf & ((1u << LW) - 1)];
    if (e & LITERAL) {
      // A run of literals that can neither overflow the block (each takes
      // one byte of room) nor overrun (a table hit takes at most LW <= 16
      // of the bits left before the limit), so none of the plain
      // version's checks can fire: store, drop, look up the next entry,
      // refill. The next index is valid before the refill: a drop leaves
      // at least 33 - LW bits.
      int64_t safe = min(out.cap - out.n, (limit - bits.pos) >> 4);
      int run = (int)min(safe, (int64_t)(1 << 30));
      if (run > 0) {
        do {
          // every lane stores the same byte: no branch on the lane
          const uint8_t b = (uint8_t)(e >> 4);
          bits.drop(e & 15);
          e = lit.tab[bits.buf & ((1u << LW) - 1)];
          out.p[out.n++] = b;
          bits.fill();
        } while ((e & LITERAL) && --run > 0);
        continue;
      }
    }
    if (!(e & 15)) {  // a code longer than the table, or none
      e = walk((uint32_t)bits.buf, lit.cnt, lit.sym, 15, KIND_LIT);
      if (!e) return ST_BAD_CODE;
    }
    const uint32_t sym = (e >> 4) & 511;
    bits.drop(e & 15);
    // a literal with room and no overrun: the one branch of the common case
    if ((sym < 256) & (out.n < out.cap) & (bits.pos <= limit)) {
      out.p[out.n++] = (uint8_t)sym;
      continue;
    }
    if (sym < 256) {
      if (out.n >= out.cap)
        return bits.pos > limit ? ST_IN_OVERRUN : ST_OUT_OVERFLOW;
      out.p[out.n++] = (uint8_t)sym;
      return ST_IN_OVERRUN;
    }
    if (sym == 256) return bits.pos > limit ? ST_IN_OVERRUN : ST_OK;
    if (sym > 285) return bits.pos > limit ? ST_IN_OVERRUN : ST_BAD_CODE;
    // the length's extra bits
    uint32_t ext = (e >> 13) & 15;
    uint32_t length = (e >> 17) + bits.take(ext);
    if (bits.pos > limit) return ST_IN_OVERRUN;
    bits.fill();
    e = dist.tab[bits.buf & ((1u << DW) - 1)];
    if (!(e & 15)) {
      e = walk((uint32_t)bits.buf, dist.cnt, dist.sym, 15, KIND_DIST);
      if (!e) return ST_BAD_CODE;
    }
    int nb = e & 15;
    if (((e >> 4) & 511) > 29) {
      bits.drop(nb);
      return bits.pos > limit ? ST_IN_OVERRUN : ST_BAD_CODE;
    }
    ext = (e >> 13) & 15;
    uint32_t d = (e >> 17) + ((uint32_t)(bits.buf >> nb) & ((1u << ext) - 1));
    bits.drop(nb + ext);
    if (bits.pos > limit) return ST_IN_OVERRUN;
    if (d > out.n || d > 32768) return ST_BAD_DIST;
    int64_t room = out.cap - out.n;
    if ((int64_t)length > room) {
      copy_match(out, d, (uint32_t)room, lane);
      return ST_OUT_OVERFLOW;
    }
    copy_match(out, d, length, lane);
  }
}

__device__ int inflate_stream(Bits& bits, Out& out, WarpSmem& s,
                              const FixedSmem& fx, int64_t limit,
                              const uint8_t* pay, int lane) {
  const Code fixed_lit{fx.lit, fx.lit_cnt, fx.lit_sym};
  const Code fixed_dist{fx.dist, fx.dist_cnt, fx.dist_sym};
  const Code dyn_lit{s.lit, s.lit_cnt, s.lit_sym};
  const Code dyn_dist{s.dist, s.dist_cnt, s.dist_sym};
  for (;;) {
    bits.fill();
    uint32_t hdr = bits.take(3);
    uint32_t bfinal = hdr & 1, btype = hdr >> 1;
    if (btype == 0) bits.drop((int)((-bits.pos) & 7));
    if (bits.pos > limit) return ST_IN_OVERRUN;
    if (btype == 3) return ST_BAD_BTYPE;
    int st;
    if (btype == 0) {
      st = stored(bits, out, limit, pay, lane);
    } else if (btype == 1) {
      st = codes(bits, out, fixed_lit, fixed_dist, limit, lane);
    } else {
      st = dynamic_tables(bits, s, limit, lane);
      if (st != ST_OK) return st;
      st = codes(bits, out, dyn_lit, dyn_dist, limit, lane);
    }
    if (st != ST_OK) return st;
    if (bfinal) return ST_OK;
  }
}

// The fixed code's tables, built by one warp.
__device__ void fixed_tables(FixedSmem& fx, WarpSmem& s, int lane) {
  for (int i = lane; i < NLENS; i += 32)
    s.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < NLIT ? 8 : 5;
  __syncwarp();
  construct(s.lens, NLIT, fx.lit_cnt, fx.lit_sym, s.run, lane);
  construct(s.lens + NLIT, NDIST, fx.dist_cnt, fx.dist_sym, s.run, lane);
  fill_table<LW>(fx.lit, fx.lit_cnt, fx.lit_sym, KIND_LIT, lane);
  fill_table<DW>(fx.dist, fx.dist_cnt, fx.dist_sym, KIND_DIST, lane);
}

#define SMEM_BYTES (sizeof(FixedSmem) + WARPS * sizeof(WarpSmem))
static_assert(SMEM_BYTES <= 48 * 1024, "launch needs no opt-in");

__global__ void __launch_bounds__(32 * WARPS)
inflate_kernel(const uint8_t* __restrict__ comp,
               const int64_t* __restrict__ pay_off,
               const int64_t* __restrict__ pay_len,
               const int64_t* __restrict__ out_off, uint8_t* out,
               int32_t* __restrict__ out_len, int32_t* __restrict__ status,
               int64_t n) {
  extern __shared__ __align__(16) uint8_t smem[];
  FixedSmem& fx = *reinterpret_cast<FixedSmem*>(smem);
  WarpSmem* ws = reinterpret_cast<WarpSmem*>(smem + sizeof(FixedSmem));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) fixed_tables(fx, ws[0], lane);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * WARPS + warp;
  if (i >= n) return;
  const uint8_t* pay = comp + pay_off[i];
  const int64_t clen = pay_len[i];
  Out o{out + out_off[i], 0, out_off[i + 1] - out_off[i]};
  int st = ST_OK;
  if (clen > 0) {
    const int64_t head = (int64_t)((uintptr_t)pay & 3);
    Bits bits;
    bits.w = reinterpret_cast<const uint32_t*>(pay - head);
    bits.len = clen;
    bits.head = head;
    bits.seek(0);
    st = inflate_stream(bits, o, ws[warp], fx, (clen + 8) * 8, pay, lane);
  }
  if (st == ST_OK && o.n != o.cap) st = ST_ISIZE_MISMATCH;
  if (lane == 0) {
    out_len[i] = (int32_t)o.n;
    status[i] = st;
  }
}

extern "C" int disq_inflate_launch(const void* comp, const void* pay_off,
                                   const void* pay_len, const void* out_off,
                                   void* out, void* out_len, void* status,
                                   int64_t n, void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + WARPS - 1) / WARPS);
  inflate_kernel<<<grid, 32 * WARPS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int64_t*)pay_off, (const int64_t*)pay_len,
      (const int64_t*)out_off, (uint8_t*)out, (int32_t*)out_len,
      (int32_t*)status, n);
  return (int)cudaGetLastError();
}

// Launch geometry for n payloads: threads per block, payloads per block,
// dynamic shared memory per block (bytes), blocks.
extern "C" void disq_inflate_geometry(int64_t n, int64_t* g) {
  g[0] = 32 * WARPS;
  g[1] = WARPS;
  g[2] = (int64_t)SMEM_BYTES;
  g[3] = n > 0 ? (n + WARPS - 1) / WARPS : 0;
}
