// The rule-free parts of a raw-DEFLATE (RFC 1951) decoder run by one warp
// per payload, shared by the two inflate kernels: csrc/inflate.cu (B1) and
// csrc/inflate_legacy.cu (B4). Each kernel keeps its own decoding rules --
// when a stream has overrun, which distances it accepts, what a block past
// the output's capacity does -- and takes from here only what both compute
// the same way:
//
// - the RFC 1951 constant tables and the status codes;
// - the canonical code of a set of lengths (puff's construct, with no
//   completeness check), its canonical walk, and tables filled by
//   evaluating that walk on every bit pattern of their width;
// - a 64-bit LSB-first bit buffer over one payload, refilled from aligned
//   words loaded one refill ahead, bytes at and past the payload's end
//   read as zero;
// - the warp-cooperative match copy.
//
// Everything here runs on all 32 lanes of a warp on the same values, except
// the loops that split a table build or a copy across the lanes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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
