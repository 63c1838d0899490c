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
// The rule-free parts -- constant tables, canonical code and table fill, bit
// buffer, warp copy -- live in csrc/inflate_core.cuh, shared with B4
// (csrc/inflate_legacy.cu); the rule-bearing steps are here.
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

#include "inflate_core.cuh"

#define WARPS 4        // payloads (warps) per block

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
