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
