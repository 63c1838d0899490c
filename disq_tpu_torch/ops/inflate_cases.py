"""Raw-DEFLATE payloads that drive the inflate kernel through every
status code, and well-formed ones of every block type.

Used to hold the kernel against its plain version (and the reference's
kernel) on faults as well as on good data. Each case is
``(name, payload, usize, expected status)``; payloads are built bit by
bit, so they do not depend on any compressor's choices.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np

from disq_tpu_torch.ops.inflate import CLORDER, DBASE, DEXT, LBASE, LEXT


class BitWriter:
    """LSB-first DEFLATE bit packer."""

    def __init__(self) -> None:
        self.bits: List[int] = []

    def put(self, value: int, n: int) -> "BitWriter":
        """``n`` bits of ``value``, least significant first (header
        fields, extra bits)."""
        self.bits.extend((value >> i) & 1 for i in range(n))
        return self

    def code(self, code: int, n: int) -> "BitWriter":
        """An ``n``-bit Huffman code, most significant bit first."""
        self.bits.extend((code >> (n - 1 - i)) & 1 for i in range(n))
        return self

    def align(self) -> "BitWriter":
        self.bits.extend([0] * (-len(self.bits) % 8))
        return self

    def raw(self, data: bytes) -> "BitWriter":
        self.align()
        for b in data:
            self.put(b, 8)
        return self

    def tobytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            sum(bits[i + j] << j for j in range(8))
            for i in range(0, len(bits), 8))


def _stored(length: int, nlen: int, data: bytes) -> bytes:
    w = BitWriter().put(1, 1).put(0, 2).align()
    return w.put(length, 16).put(nlen, 16).raw(data).tobytes()


def _dynamic_header(hlit: int, hdist: int, cl_lens: dict) -> BitWriter:
    """Final dynamic block header: HLIT/HDIST/HCLEN and the code-length
    code lengths (``{symbol: length}``); HCLEN covers them all."""
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
    hclen = max(order.index(s) for s in cl_lens) + 1
    hclen = max(hclen, 4)
    w = BitWriter().put(1, 1).put(2, 2)
    w.put(hlit - 257, 5).put(hdist - 1, 5).put(hclen - 4, 4)
    for s in order[:hclen]:
        w.put(cl_lens.get(s, 0), 3)
    return w


def status_cases() -> List[Tuple[str, bytes, int, int]]:
    """One or more payloads per status code 1..8."""
    cases = []
    cases.append(("bad_btype", BitWriter().put(1, 1).put(3, 2).tobytes(), 10, 1))
    cases.append(("stored_nlen", _stored(5, 0x0000, b"abcde"), 5, 2))
    # fixed Huffman: literal/length 286 (8-bit code 11000110) is invalid
    cases.append(("fixed_len_286", BitWriter().put(1, 1).put(1, 2)
                  .code(0b11000110, 8).tobytes(), 10, 3))
    # fixed Huffman: length 3 (code 0000001) then distance code 30
    cases.append(("fixed_dist_30", BitWriter().put(1, 1).put(1, 2)
                  .code(0b0000001, 7).code(30, 5).tobytes(), 10, 3))
    # dynamic: an incomplete code-length code (one 2-bit code) whose
    # unassigned codes do not decode
    cases.append(("dyn_incomplete", _dynamic_header(257, 1, {0: 2})
                  .code(0b11, 2).tobytes(), 10, 3))
    # fixed Huffman: a match of distance 1 with nothing written yet
    cases.append(("dist_before_start", BitWriter().put(1, 1).put(1, 2)
                  .code(0b0000001, 7).code(0, 5).tobytes(), 10, 4))
    cases.append(("overflow", _stored(2000, 2000 ^ 0xFFFF, bytes(range(250)) * 8),
                  100, 5))
    cases.append(("truncated_stored", _stored(1000, 1000 ^ 0xFFFF, b"x" * 10),
                  1000, 6))
    truncated = zlib.compress(np.random.default_rng(5).integers(
        0, 4, 2400, dtype=np.uint8).tobytes(), 9)[2:-4]
    cases.append(("truncated_dynamic", truncated[: len(truncated) // 4],
                  1000, 6))
    # code-length codes {0: 1 bit, 16: 1 bit}; code 1 = repeat with
    # nothing to repeat yet
    cases.append(("repeat_first", _dynamic_header(257, 1, {0: 1, 16: 1})
                  .code(1, 1).put(0, 2).tobytes(), 10, 7))
    # codes {0: 1 bit, 18: 1 bit}: 18 repeats zero 138 times, three
    # times over 258 lengths
    cases.append(("repeat_past_end", _dynamic_header(257, 1, {0: 1, 18: 1})
                  .code(1, 1).put(127, 7).code(1, 1).put(127, 7)
                  .tobytes(), 10, 7))
    cases.append(("isize_short", _stored(5, 5 ^ 0xFFFF, b"abcde"), 9, 8))
    return cases


def legacy_cases() -> List[Tuple[str, bytes, int, int]]:
    """Payloads where kernel B4's rules (``ops/inflate.py``) decide:
    ``(name, payload, usize, B4's status)``."""
    # fixed Huffman: literal 'a', then 260 matches of length 258 at
    # distance 1 — 67,081 bytes, past the 65,536-byte row
    w = BitWriter().put(1, 1).put(1, 2).code(0x30 + ord("a"), 8)
    for _ in range(260):
        w.code(0xC0 + 285 - 280, 8).code(0, 5)
    runaway = w.code(0, 7).tobytes()
    stored = _stored(3, 3 ^ 0xFFFF, b"abc")
    return [
        ("row_overflow", runaway, -1, 5),
        ("row_overflow_isize", runaway, 67081, 5),
        # a non-final stored block and nothing after it: the next header
        # reads zeros, a stored block of LEN 0 and NLEN 0
        ("cut_after_block", bytes([stored[0] & ~1]) + stored[1:], 3, 2),
        ("empty_payload", b"", -1, 2),
        ("isize_unchecked", stored, -1, 0),
        ("isize_long", stored, 2, 8),
    ]


def _fixed_literal(w: BitWriter, b: int) -> BitWriter:
    return w.code(0x30 + b, 8) if b < 144 else w.code(0x190 + b - 144, 9)


def _fixed_match(w: BitWriter, length: int, dist: int) -> BitWriter:
    """A length/distance pair in the fixed code."""
    li = max(i for i, b in enumerate(LBASE[:29]) if b <= length)
    sym = 257 + li
    if sym < 280:
        w.code(sym - 256, 7)
    else:
        w.code(0xC0 + sym - 280, 8)
    w.put(length - int(LBASE[li]), int(LEXT[li]))
    di = max(i for i, b in enumerate(DBASE[:30]) if b <= dist)
    return w.code(di, 5).put(dist - int(DBASE[di]), int(DEXT[di]))


def _fixed_block(w: BitWriter, literals: bytes, matches=(),
                 final: bool = False) -> BitWriter:
    """A fixed-code block: the literals, then each (length, distance)."""
    w.put(int(final), 1).put(1, 2)
    for b in literals:
        _fixed_literal(w, b)
    for length, dist in matches:
        _fixed_match(w, length, dist)
    return w.code(0, 7)


def _canonical_codes(lens: dict) -> dict:
    """RFC 1951 3.2.2: ``{symbol: (code, length)}`` of a code that is not
    over-subscribed."""
    count = [0] * 16
    for ln in lens.values():
        count[ln] += 1
    nxt, code = [0] * 16, 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1 if ln > 1 else 0
        nxt[ln] = code
    out = {}
    for s in sorted(lens):
        out[s] = (nxt[lens[s]], lens[s])
        nxt[lens[s]] += 1
    return out


def _dynamic_tables(w: BitWriter, lit_lens: dict, dist_lens: dict,
                    final: bool = True) -> BitWriter:
    """A dynamic block's header and code lengths; the code-length code
    gives every length 0-15 a 4-bit code (no run-length symbols)."""
    hlit = max(257, max(lit_lens) + 1)
    hdist = max(1, max(dist_lens) + 1)
    w.put(int(final), 1).put(2, 2)
    w.put(hlit - 257, 5).put(hdist - 1, 5).put(19 - 4, 4)
    for s in CLORDER:
        w.put(0 if s >= 16 else 4, 3)
    for s in range(hlit):
        w.code(lit_lens.get(s, 0), 4)
    for s in range(hdist):
        w.code(dist_lens.get(s, 0), 4)
    return w


def edge_cases() -> List[Tuple[str, bytes, int, int]]:
    """Payloads at the edges of a table-driven, warp-cooperative decoder,
    each ``(name, payload, usize, expected status)``: codes longer than
    a 10-bit lit/len and an 8-bit distance table, an over-subscribed
    lit/len set, incomplete sets whose gap lies below and above the
    table width, overlapping matches at short distances, a match and
    stored blocks that cross the capacity or run past the payload, and
    several fixed blocks in a row."""
    cases = []
    # lit/len codes of 1-15 bits, distance codes of 1-10 bits, all complete
    lit_lens = {65 + k: k + 1 for k in range(14)}
    lit_lens.update({256: 15, 257: 15})
    dist_lens = {0: 10, 1: 10}
    dist_lens.update({d: 11 - d for d in range(2, 11)})
    lc, dc = _canonical_codes(lit_lens), _canonical_codes(dist_lens)
    w = _dynamic_tables(BitWriter(), lit_lens, dist_lens)
    for s in (78, 77, 76, 75, 65, 66, 74):      # 14, 13, 12, 11, 1, 2, 10 bits
        w.code(*lc[s])
    for d in (0, 1, 2, 3):                      # length 3 at distance 1-4
        w.code(*lc[257]).code(*dc[d])
    for s in (78, 67, 76):
        w.code(*lc[s])
    long_codes = w.code(*lc[256]).tobytes()
    cases.append(("long_codes", long_codes, 22, 0))
    # over-subscribed lit/len: EOB 1 bit, four 2-bit literals; the walk's
    # first match decodes bit 1 then bit b as literal 65 + b (67, 68 never)
    w = _dynamic_tables(BitWriter(), {256: 1, 65: 2, 66: 2, 67: 2, 68: 2},
                        {0: 1})
    cases.append(("oversubscribed", w.put(1, 1).put(0, 1).put(1, 1).put(1, 1)
                  .put(1, 1).put(0, 1).put(0, 1).tobytes(), 3, 0))
    # incomplete sets: the unassigned code 11 (2 bits, below the width) and
    # twelve 1 bits (above it) decode to nothing
    w = _dynamic_tables(BitWriter(), {65: 1, 256: 2}, {0: 1})
    cases.append(("gap_below_width", w.code(0, 1).put(3, 2).tobytes(), 1, 3))
    lens = {65 + k: k + 1 for k in range(11)}
    lens[256] = 12
    lc = _canonical_codes(lens)
    w = _dynamic_tables(BitWriter(), lens, {0: 1})
    cases.append(("gap_above_width", w.code(*lc[75]).code(*lc[65])
                  .put(0xFFF, 12).tobytes(), 2, 3))
    # overlapping matches: 40 literals, then lengths 3-258 at distance d
    seed_bytes = bytes(range(48, 88))
    lengths = (3, 4, 31, 32, 33, 64, 100, 258)
    for d in (1, 2, 3, 31, 32, 33):
        w = _fixed_block(BitWriter(), seed_bytes,
                         [(ln, d) for ln in lengths], final=True)
        cases.append((f"overlap_d{d}", w.tobytes(),
                      len(seed_bytes) + sum(lengths), 0))
    # a match that crosses the capacity: 10 x 258 bytes into 700
    w = _fixed_block(BitWriter(), b"a", [(258, 1)] * 10, final=True)
    cases.append(("match_past_cap", w.tobytes(), 700, 5))
    # a stored block that runs past the payload, at each output alignment
    # (and payload ends 20-23 bytes into its data)
    for a in range(4):
        w = _fixed_block(BitWriter(), b"xyz"[:a])
        w.put(1, 1).put(0, 2).align().put(100, 16).put(100 ^ 0xFFFF, 16)
        cases.append((f"stored_past_end_a{a}", w.raw(bytes(range(1, 21 + a)))
                      .tobytes(), a + 100, 6))
    # a stored block that crosses the capacity, at each output alignment
    for a in range(4):
        w = _fixed_block(BitWriter(), b"xyz"[:a])
        w.put(1, 1).put(0, 2).align().put(30, 16).put(30 ^ 0xFFFF, 16)
        cases.append((f"stored_past_cap_a{a}", w.raw(bytes(range(1, 31)))
                      .tobytes(), a + 13, 5))
    # several fixed blocks in a row
    w = BitWriter()
    for k in range(5):
        _fixed_block(w, bytes([97 + k]) * 3 + b"\x90\xff", [(5, 4)])
    w = _fixed_block(w, b"end", final=True)
    cases.append(("fixed_in_a_row", w.tobytes(), 5 * 10 + 3, 0))
    return cases


def _nine_bit_pad(w: BitWriter, more: int) -> BitWriter:
    """9-bit fixed literals (byte 144 on) until ``more`` further bits end
    on a byte boundary: each one moves the bit count by 1 mod 8."""
    b = 144
    while (len(w.bits) + more) % 8:
        _fixed_literal(w, b)
        b += 1
    return w


def _row_of(n: int, w: BitWriter) -> BitWriter:
    """Fixed-code symbols for ``n`` bytes: one literal, then matches of
    258 and one shorter match at distance 1."""
    _fixed_literal(w, ord("a"))
    n -= 1
    while n >= 258:
        _fixed_match(w, 258, 1)
        n -= 258
    if n:
        _fixed_match(w, n, 1)
    return w


def legacy_edge_cases() -> List[Tuple[str, bytes, int, int]]:
    """Payloads where kernel B4's own rules (``ops/inflate.py``) decide,
    one or more per rule, each ``(name, payload, usize, B4's status)``:
    the overrun decided inside the walk, the check after a match,
    distances, the row's capacity, stored blocks, the end of a block, and
    a dynamic block whose code lengths fail before its data."""
    cases = []

    def fixed():  # a final fixed block's header
        return BitWriter().put(1, 1).put(1, 2)

    # (a) the last literal's 9-bit code (110010000, byte 144) completes
    # exactly on the first bit past the payload: 6, the byte not written
    w = fixed()
    for b in range(144, 149):                 # 3 + 5 x 9 = 48 bits
        _fixed_literal(w, b)
    cases.append(("code_ends_past_limit", w.code(0b11001000, 8).tobytes(),
                  -1, 6))
    # (a) code-length codes are at most 7 bits, yet a miss is 6 when the
    # first bit past the payload lies within 15 bits, 3 only farther away
    # (the one 2-bit code '00' leaves '11' without a symbol)
    near = _dynamic_header(257, 1, {0: 2}).code(0b11, 2).tobytes()
    cases.append(("cl_miss_near_limit", near, -1, 6))
    cases.append(("cl_miss_far_from_limit", near + bytes(2), -1, 3))
    # (a) the first code length starts on the payload's end (HCLEN 13:
    # 56 header bits): a repeat (16, code '0') that completes on the first
    # bit past it is returned with status 6, and a 16 with nothing to
    # repeat makes that 7; a 16 of 2 bits does not complete there: 6
    cases.append(("cl_repeat_at_limit", _dynamic_header(
        257, 1, {16: 1, 17: 1, 12: 0}).tobytes(), -1, 7))
    cases.append(("cl_repeat_past_limit", _dynamic_header(
        257, 1, {16: 2, 17: 2, 18: 2, 12: 0}).tobytes(), -1, 6))
    # (b) a match whose distance-extra bit lies past the payload (it reads
    # as 0: distance 5) is copied, then flagged: 6 with 9 bytes written
    w = fixed()
    for b in b"abcde":
        _fixed_literal(w, b)
    _nine_bit_pad(w, 7 + 5)
    w.code(1, 7).code(4, 5)                   # length 3, distances 5-6
    cases.append(("dist_extra_past_limit", w.tobytes(), -1, 6))
    # (b) a match whose length-extra bit lies past the payload: its
    # distance code starts past the limit: 6, nothing copied
    w = fixed()
    for b in b"abcde":
        _fixed_literal(w, b)
    _nine_bit_pad(w, 7)
    cases.append(("length_extra_past_limit", w.code(265 - 256, 7).tobytes(),
                  -1, 6))
    # (c) distance 32,768, the largest a code can give: accepted
    hist = bytes(range(256)) * 128
    w = BitWriter().put(0, 1).put(0, 2).align()
    w.put(len(hist), 16).put(len(hist) ^ 0xFFFF, 16).raw(hist)
    cases.append(("distance_32768", _fixed_block(
        w, b"", [(3, 32768)], final=True).tobytes(), 32771, 0))
    # (c) distance symbols 30 and 31 are 4; lit/len 286 and 287 are 3; a
    # distance past the bytes written is 4
    for sym in (30, 31):
        w = _fixed_literal(fixed(), ord("a")).code(1, 7).code(sym, 5)
        cases.append((f"dist_symbol_{sym}", w.tobytes(), -1, 4))
    for sym in (286, 287):
        w = _fixed_literal(fixed(), ord("a")).code(0xC0 + sym - 280, 8)
        cases.append((f"lit_symbol_{sym}", w.tobytes(), -1, 3))
    w = _fixed_literal(fixed(), ord("a"))
    cases.append(("dist_past_written", _fixed_match(w, 3, 2).tobytes(),
                  -1, 4))
    # (d) the row's 65,536 bytes: filled exactly, then end-of-block (0);
    # then one literal more (5); 65,533 bytes then a match of 4 (5,
    # nothing of it copied)
    w = _row_of(65536, fixed())
    cases.append(("row_exactly_full", w.code(0, 7).tobytes(), 65536, 0))
    w = _fixed_literal(_row_of(65536, fixed()), ord("b"))
    cases.append(("literal_past_row", w.tobytes(), -1, 5))
    w = _fixed_match(_row_of(65533, fixed()), 4, 1)
    cases.append(("match_past_row", w.tobytes(), -1, 5))
    # (e) a stored block checks LEN/NLEN, then room, then the payload's
    # end, and copies all of its bytes or none

    def lead():  # a non-final fixed block of two literals
        w = BitWriter().put(0, 1).put(1, 2)
        return _fixed_literal(_fixed_literal(w, ord("a")), ord("b")).code(0, 7)

    w = lead().put(1, 1).put(0, 2).align().put(65535, 16).put(1, 16)
    cases.append(("stored_nlen_before_room", w.raw(b"x" * 10).tobytes(),
                  -1, 2))
    w = lead().put(1, 1).put(0, 2).align().put(65535, 16)
    w.put(65535 ^ 0xFFFF, 16)
    cases.append(("stored_room_before_end", w.raw(b"x" * 10).tobytes(),
                  -1, 5))
    w = lead().put(1, 1).put(0, 2).align().put(100, 16).put(100 ^ 0xFFFF, 16)
    cases.append(("stored_past_end_after_data", w.raw(b"y" * 20).tobytes(),
                  -1, 6))
    w = lead().put(1, 1).put(0, 2).align().put(20, 16).put(20 ^ 0xFFFF, 16)
    cases.append(("stored_to_the_end", w.raw(b"z" * 20).tobytes(), 22, 0))
    # (f) a final block whose end-of-block code ends exactly on the
    # payload's end: no slack is needed, and none is taken
    w = fixed()
    for b in b"abc":
        _fixed_literal(w, b)
    _nine_bit_pad(w, 7)
    cases.append(("eob_at_limit", w.code(0, 7).tobytes(), -1, 0))
    # (g) code lengths that fail still leave their data decoded with the
    # lengths read so far. A miss after 256 lengths of 8 (code-length
    # codes: 8 -> '0', 18 -> '10'): 3, then literals of that 8-bit code
    # from 15 bits on, up to the payload's end (no end-of-block code)
    w = _dynamic_header(257, 1, {8: 1, 18: 2})
    for _ in range(256):
        w.code(0, 1)
    w.code(0b11, 2).put(0, 13)
    for b in b"failed header":
        w.code(b, 8)
    cases.append(("cl_bad_code_then_data", w.tobytes(), -1, 3))
    # a repeat past HLIT + HDIST after 257 lengths of 9 (9 -> '0',
    # 17 -> '1'): 7, then literals and end-of-block of that 9-bit code
    w = _dynamic_header(257, 1, {9: 1, 17: 1})
    for _ in range(257):
        w.code(0, 1)
    w.code(1, 1).put(0, 3)
    for b in b"repeat":
        w.code(b, 9)
    cases.append(("cl_repeat_overflow_then_data", w.code(256, 9).tobytes(),
                  -1, 7))
    return cases


def good_cases(seed: int = 0) -> List[Tuple[str, bytes, bytes]]:
    """(name, payload, decoded) for stored, fixed and dynamic blocks at
    zlib levels 1, 6 and 9 over small BAM-like and random inputs."""
    rng = np.random.default_rng(seed)
    text = b"".join(
        b"read%05d\tACGT%s\tNM:i:%d\n" % (
            i, rng.choice(list(b"ACGT"), 40).astype(np.uint8).tobytes(), i % 7)
        for i in range(8))
    noise = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    runs = b"A" * 200 + b"CG" * 50 + bytes(range(64))
    out = []
    for name, data in (("text", text), ("noise", noise), ("runs", runs)):
        for level in (1, 6, 9):
            c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
            out.append((f"{name}_l{level}", c.compress(data) + c.flush(), data))
        c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
        out.append((f"{name}_fixed", c.compress(data) + c.flush(), data))
        c = zlib.compressobj(0, zlib.DEFLATED, -15, 8)
        out.append((f"{name}_stored", c.compress(data) + c.flush(), data))
    out.append(("empty", b"\x03\x00", b""))
    return out
