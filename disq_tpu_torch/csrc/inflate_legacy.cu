// Raw-DEFLATE (RFC 1951) decode under the reference's older rules, one warp
// per payload (kernel B4).
//
// Replaces disq_tpu/ops/inflate.py:_inflate_kernel, the round-1 Pallas
// decoder that runs one BGZF payload per grid program, and computes what it
// computes: row i of a (B, 65536) uint8 slab, zero past the bytes written,
// and meta[i] = [len, status], with its status codes (0 ok, 1 bad BTYPE,
// 2 stored LEN mismatch, 3 bad Huffman code, 4 invalid distance, 5 output
// overflow, 6 ran past the payload, 7 code-length repeat overflow, 8 ISIZE
// mismatch) and its rules, which are not B1's (csrc/inflate.cu):
//
// - bytes past the payload read as zero, and the stream has overrun as
//   soon as its bit cursor passes limit = csize * 8, with no slack;
// - a symbol is the canonical walk of up to 15 bits; a code that would end
//   past the limit is 6, and so is a walk that reaches the first bit past
//   the limit without a match, in every alphabet; 3 only when 15 bits
//   before the limit hold no code;
// - after each literal or match the cursor past the limit is 6, so a match
//   whose distance-extra bits cross it is copied first, then flagged;
// - a lit/len symbol over 285 is 3; a distance symbol over 29 or a
//   distance past the bytes written is 4, with no 32 KiB window check;
// - a row holds 65,536 bytes: a literal, match or stored block past it is
//   5 and writes nothing; matches and stored blocks are all or nothing;
// - a stored block checks LEN/NLEN (2), then room (5), then its bytes
//   against the payload's end (6);
// - a dynamic block whose code lengths fail still decodes its data with
//   the lengths read so far, and its status is the lengths' error;
// - usize >= 0 checks the output length (8); -1 skips the check.
//
// Each status is decided after the same step as in the plain version,
// _Stream in disq_tpu_torch/ops/inflate.py, which defines the function, and
// a flagged payload has written exactly the bytes that version writes.
//
// What bounds it on this card: DEFLATE is bit-serial within a payload, so a
// payload is one chain of dependent table reads and branches -- latency,
// not bytes or operations (a split's bytes take well under a millisecond at
// 3.35 TB/s). The design is B1's, with its rule-free parts shared through
// csrc/inflate_core.cuh:
//
// - One warp per payload, WARPS warps per block: a 64 MiB split (~1,830
//   payloads) is one wave of ~14 warps on every SM. The lanes run the
//   decode in lockstep on broadcast values and split what is parallel:
//   table builds, match copies, stored copies, the row's zero tail.
// - Table-driven Huffman decode. A table hit is taken as it is when its
//   code ends at or before the limit; anything else -- a miss within the
//   table's width, or a code that would end past the limit -- goes to
//   `symbol_slow`, which evaluates the reference's walk and its overrun
//   rule exactly. The code-length table covers every code-length code
//   (7 bits), but a miss there is still decided by the 15-bit rule.
// - Runs of literals decode with no per-symbol status test, cut to the
//   row's room and to the bits before the limit that no table hit of the
//   run can cross.
// - Output goes straight to row b of the slab; matches read their sources
//   back from it. After the decode the warp zeroes the rest of the row with
//   16-byte stores: the wrapper allocates the slab uninitialised.

#include <cstdint>
#include <cuda_runtime.h>

#include "inflate_core.cuh"

#define WARPS 4        // payloads (warps) per block
#define UMAX 65536     // bytes per output row

// The reference's symbol decode from table entry `e` (0: no code within the
// table's width), when the fast test in `symbol` fails: the walk's first
// match of up to 15 bits stands when it ends at or before the limit;
// otherwise, when the first bit past the limit lies within 15 bits, the
// decode has overrun (6) with its cursor just past that bit and the match
// as its entry only when the match ends exactly there; otherwise no code
// matched (3) after 15 bits. Returns the entry, 0 for no symbol.
__device__ __forceinline__ uint32_t symbol_slow(uint32_t e, Bits& bits,
                                                const Code& c,
                                                int64_t limit, Kind kind,
                                                int& st) {
  if (!(e & 15)) e = walk((uint32_t)bits.buf, c.cnt, c.sym, 15, kind);
  const int64_t len = e & 15;
  const int64_t over = max(limit - bits.pos + 1, (int64_t)1);
  if (len && len < over) {
    bits.drop((int)len);
    st = ST_OK;
    return e;
  }
  if (over <= 15) {
    bits.drop((int)over);
    st = ST_IN_OVERRUN;
    return len == over ? e : 0u;
  }
  bits.drop(15);
  st = ST_BAD_CODE;
  return 0u;
}

// One symbol from table entry `e`; the buffer holds at least 15 bits.
__device__ __forceinline__ uint32_t symbol(uint32_t e, Bits& bits,
                                           const Code& c, int64_t limit,
                                           Kind kind, int& st) {
  if ((e & 15) && bits.pos + (e & 15) <= limit) {
    bits.drop(e & 15);
    st = ST_OK;
    return e;
  }
  return symbol_slow(e, bits, c, limit, kind, st);
}

// Literal/length and distance symbols up to end-of-block.
__device__ int codes(Bits& bits, Out& out, const Code& lit, const Code& dist,
                     int64_t limit, int lane) {
  for (;;) {
    bits.fill();
    uint32_t e = lit.tab[bits.buf & ((1u << LW) - 1)];
    if (e & LITERAL) {
      // A run of literals that can neither overflow the row (each takes
      // one byte of room) nor overrun (each is a table hit of at most
      // LW <= 16 bits), so none of the plain version's checks can fire.
      // The next index is valid before the refill: a drop leaves at least
      // 33 - LW bits.
      const int64_t safe = min(out.cap - out.n, (limit - bits.pos) >> 4);
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
    int st;
    e = symbol(e, bits, lit, limit, KIND_LIT, st);
    if (st != ST_OK) return st;
    const uint32_t sym = (e >> 4) & 511;
    if (sym < 256) {
      if (out.n >= out.cap) return ST_OUT_OVERFLOW;
      out.p[out.n++] = (uint8_t)sym;
      continue;  // a symbol that ends by the limit leaves no overrun
    }
    if (sym == 256) return ST_OK;
    if (sym > 285) return ST_BAD_CODE;
    const uint32_t length = (e >> 17) + bits.take((e >> 13) & 15);
    bits.fill();
    e = symbol(dist.tab[bits.buf & ((1u << DW) - 1)], bits, dist, limit,
               KIND_DIST, st);
    if (st != ST_OK) return st;
    if (((e >> 4) & 511) > 29) return ST_BAD_DIST;
    const uint32_t d = (e >> 17) + bits.take((e >> 13) & 15);
    if (d > out.n) return ST_BAD_DIST;
    if (out.n + length > out.cap) return ST_OUT_OVERFLOW;
    copy_match(out, d, length, lane);
    if (bits.pos > limit) return ST_IN_OVERRUN;  // extra bits past the end
  }
}

// A stored block after its 3 header bits: all or nothing.
__device__ int stored(Bits& bits, Out& out, int64_t limit,
                      const uint8_t* pay, int lane) {
  bits.drop((int)((-bits.pos) & 7));
  bits.fill();
  const uint32_t length = bits.take(16);
  const uint32_t nlen = bits.take(16);
  if ((nlen ^ 0xFFFFu) != length) return ST_BAD_STORED;
  if (out.n + length > out.cap) return ST_OUT_OVERFLOW;
  if (bits.pos + 8 * (int64_t)length > limit) return ST_IN_OVERRUN;
  const int64_t B = bits.pos >> 3;  // byte-aligned, inside the payload
  for (int64_t j = lane; j < length; j += 32) out.p[out.n + j] = pay[B + j];
  out.n += length;
  bits.seek(B + length);
  return ST_OK;
}

// A dynamic block after its 3 header bits: the code lengths, then the data
// with the tables of the lengths read, whether or not all of them were.
__device__ int dynamic(Bits& bits, Out& out, WarpSmem& s, int64_t limit,
                       int lane) {
  bits.fill();
  const uint32_t v = bits.take(14);
  const int hlit = (v & 31) + 257, hdist = ((v >> 5) & 31) + 1;
  const int hclen = ((v >> 10) & 15) + 4;
  if (lane < 20) s.cl_lens[lane] = 0;
  for (int j = lane; j < NLENS; j += 32) s.lens[j] = 0;
  __syncwarp();
  for (int j = 0; j < hclen; j++) {
    bits.fill();
    const uint32_t l = bits.take(3);
    if (lane == 0) s.cl_lens[c_clorder[j]] = (uint8_t)l;
  }
  __syncwarp();
  construct(s.cl_lens, 19, s.cl_cnt, s.cl_sym, s.run, lane);
  fill_table<CW>(s.cl, s.cl_cnt, s.cl_sym, KIND_CL, lane);
  const Code cl{s.cl, s.cl_cnt, s.cl_sym};
  const int total = hlit + hdist;
  int n = 0, prev = 0, st = ST_OK;
  while (n < total) {
    bits.fill();
    const uint32_t e = symbol(s.cl[bits.buf & ((1u << CW) - 1)], bits, cl,
                              limit, KIND_CL, st);
    const int sym = (e >> 4) & 511;  // 0 when no code matched
    int rep = 1, val = sym;
    // a repeat's extra bits are read even after a failed symbol, which
    // moves the cursor the data loop starts from
    if (sym == 16) {
      rep = 3 + (int)bits.take(2);
      val = prev;
    } else if (sym == 17) {
      rep = 3 + (int)bits.take(3);
      val = 0;
    } else if (sym == 18) {
      rep = 11 + (int)bits.take(7);
      val = 0;
    }
    if (sym == 16 && n == 0) st = ST_REPEAT_OVERFLOW;
    if (st != ST_OK) break;
    if (n + rep > total) {
      st = ST_REPEAT_OVERFLOW;
      break;
    }
    for (int j = lane; j < rep; j += 32) s.lens[n + j] = (uint8_t)val;
    n += rep;
    prev = val;
  }
  __syncwarp();
  construct(s.lens, hlit, s.lit_cnt, s.lit_sym, s.run, lane);
  construct(s.lens + hlit, hdist, s.dist_cnt, s.dist_sym, s.run, lane);
  fill_table<LW>(s.lit, s.lit_cnt, s.lit_sym, KIND_LIT, lane);
  fill_table<DW>(s.dist, s.dist_cnt, s.dist_sym, KIND_DIST, lane);
  const Code lit{s.lit, s.lit_cnt, s.lit_sym};
  const Code dist{s.dist, s.dist_cnt, s.dist_sym};
  const int dst = codes(bits, out, lit, dist, limit, lane);
  return st != ST_OK ? st : dst;
}

__device__ int inflate_stream(Bits& bits, Out& out, WarpSmem& s,
                              const FixedSmem& fx, int64_t limit,
                              const uint8_t* pay, int lane) {
  const Code fixed_lit{fx.lit, fx.lit_cnt, fx.lit_sym};
  const Code fixed_dist{fx.dist, fx.dist_cnt, fx.dist_sym};
  for (;;) {
    bits.fill();
    const uint32_t hdr = bits.take(3);
    const uint32_t btype = hdr >> 1;
    int st;
    if (btype == 0) {
      st = stored(bits, out, limit, pay, lane);
    } else if (btype == 1) {
      st = codes(bits, out, fixed_lit, fixed_dist, limit, lane);
    } else if (btype == 2) {
      st = dynamic(bits, out, s, limit, lane);
    } else {
      return ST_BAD_BTYPE;
    }
    if (st == ST_OK && bits.pos > limit) st = ST_IN_OVERRUN;
    if (st != ST_OK || (hdr & 1)) return st;
  }
}

#define SMEM_BYTES (sizeof(FixedSmem) + WARPS * sizeof(WarpSmem))
static_assert(SMEM_BYTES <= 48 * 1024, "launch needs no opt-in");

__global__ void __launch_bounds__(32 * WARPS)
inflate_legacy_kernel(const uint8_t* __restrict__ comp,
                      const int64_t* __restrict__ pay_off,
                      const int32_t* __restrict__ csizes,
                      const int32_t* __restrict__ usizes, uint8_t* out,
                      int32_t* __restrict__ meta, int64_t n) {
  extern __shared__ __align__(16) uint8_t smem[];
  FixedSmem& fx = *reinterpret_cast<FixedSmem*>(smem);
  WarpSmem* ws = reinterpret_cast<WarpSmem*>(smem + sizeof(FixedSmem));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) fixed_tables(fx, ws[0], lane);
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b >= n) return;
  const uint8_t* pay = comp + pay_off[b];
  const int64_t csize = csizes[b];
  Out o{out + b * UMAX, 0, UMAX};
  const int64_t head = (int64_t)((uintptr_t)pay & 3);
  Bits bits;
  bits.w = reinterpret_cast<const uint32_t*>(pay - head);
  bits.len = csize;
  bits.head = head;
  bits.seek(0);
  int st = inflate_stream(bits, o, ws[warp], fx, csize * 8, pay, lane);
  const int32_t usize = usizes[b];
  if (st == ST_OK && usize >= 0 && o.n != usize) st = ST_ISIZE_MISMATCH;
  // the rest of the row reads zero: single bytes up to a 16-byte boundary,
  // then 16-byte stores
  const int64_t a = min((o.n + 15) & ~(int64_t)15, (int64_t)UMAX);
  for (int64_t j = o.n + lane; j < a; j += 32) o.p[j] = 0;
  uint4* row4 = reinterpret_cast<uint4*>(o.p);
  for (int64_t j = a / 16 + lane; j < UMAX / 16; j += 32)
    row4[j] = make_uint4(0, 0, 0, 0);
  if (lane == 0) {
    meta[2 * b] = (int32_t)o.n;
    meta[2 * b + 1] = st;
  }
}

extern "C" int disq_inflate_legacy_launch(const void* comp, const void* pay_off,
                                          const void* csizes,
                                          const void* usizes, void* out,
                                          void* meta, int64_t n,
                                          void* stream) {
  if (n <= 0) return 0;
  unsigned grid = (unsigned)((n + WARPS - 1) / WARPS);
  inflate_legacy_kernel<<<grid, 32 * WARPS, SMEM_BYTES,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int64_t*)pay_off, (const int32_t*)csizes,
      (const int32_t*)usizes, (uint8_t*)out, (int32_t*)meta, n);
  return (int)cudaGetLastError();
}

// Launch geometry for n payloads: threads per block, payloads per block,
// dynamic shared memory per block (bytes), blocks.
extern "C" void disq_inflate_legacy_geometry(int64_t n, int64_t* g) {
  g[0] = 32 * WARPS;
  g[1] = WARPS;
  g[2] = (int64_t)SMEM_BYTES;
  g[3] = n > 0 ? (n + WARPS - 1) / WARPS : 0;
}
