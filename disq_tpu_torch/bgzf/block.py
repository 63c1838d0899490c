"""BGZF block model + virtual file offsets (SAM spec §4.1).

A BGZF file is a gzip-compatible chain of independently deflated
blocks, each at most 64 KiB compressed and uncompressed, announced by a
gzip FEXTRA subfield ``BC`` carrying ``BSIZE`` (total block size − 1).

**Virtual file offset** = ``(compressed_block_start << 16) |
offset_within_uncompressed_block``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# Fixed 18-byte BGZF member header layout:
#   magic 1f 8b, CM=8 (deflate), FLG=4 (FEXTRA), MTIME=0, XFL=0, OS=ff,
#   XLEN=6, SI1='B', SI2='C', SLEN=2, BSIZE (u16, total block size - 1)
BGZF_HEADER_SIZE = 18
BGZF_FOOTER_SIZE = 8  # CRC32 + ISIZE
BGZF_MAX_BLOCK_SIZE = 0x10000
# payload bound per written block (htsjdk's), so a worst-case
# incompressible payload still fits in one block after deflate
BGZF_MAX_PAYLOAD = 0xFF00  # 65280

_HEADER_PREFIX = bytes([0x1F, 0x8B, 0x08, 0x04])

# The fixed 28-byte empty-block EOF terminator (SAM spec §4.1.2).
BGZF_EOF_MARKER = bytes(
    [
        0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00,
        0x00, 0xFF, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00,
        0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x00, 0x00, 0x00, 0x00,
    ]
)


@dataclass(frozen=True)
class BgzfBlock:
    """One BGZF block: header offset ``pos``, total compressed size
    ``csize`` (BSIZE + 1) and uncompressed size ``usize`` (ISIZE)."""

    pos: int
    csize: int
    usize: int

    @property
    def end(self) -> int:
        return self.pos + self.csize


def make_virtual_offset(block_start: int, within: int) -> int:
    if not (0 <= within < BGZF_MAX_BLOCK_SIZE):
        raise ValueError(f"uoffset out of range: {within}")
    if block_start >= 1 << 48:
        raise ValueError(f"coffset out of range: {block_start}")
    return (block_start << 16) | within


def split_virtual_offset(voffset: int) -> tuple[int, int]:
    return voffset >> 16, voffset & 0xFFFF


def build_block_header(csize: int) -> bytes:
    """The 18-byte canonical header for a block of total size ``csize``."""
    if not (BGZF_HEADER_SIZE + BGZF_FOOTER_SIZE <= csize <= BGZF_MAX_BLOCK_SIZE):
        raise ValueError(f"bad block size {csize}")
    return _HEADER_PREFIX + struct.pack(
        "<IBBHBBHH", 0, 0, 0xFF, 6, 0x42, 0x43, 2, csize - 1
    )


def parse_block_header(buf: bytes, offset: int = 0) -> int:
    """Parse a BGZF header at ``offset``; return the total block size.
    Accepts any spec-conformant header (other extra subfields too);
    raises ValueError when the bytes are not a BGZF member header."""
    if len(buf) - offset < BGZF_HEADER_SIZE:
        raise ValueError("truncated BGZF header")
    if buf[offset:offset + 4] != _HEADER_PREFIX:
        raise ValueError("not a BGZF header (magic/FLG mismatch)")
    xlen = struct.unpack_from("<H", buf, offset + 10)[0]
    if xlen < 6:
        raise ValueError("XLEN too small for BC subfield")
    p = offset + 12
    end = p + xlen
    if end > len(buf):
        raise ValueError("truncated extra field")
    while p + 4 <= end:
        si1, si2, slen = buf[p], buf[p + 1], struct.unpack_from("<H", buf, p + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            if p + 6 > end:
                raise ValueError("truncated BC subfield")
            bsize = struct.unpack_from("<H", buf, p + 4)[0]
            total = bsize + 1
            if total < 12 + xlen + BGZF_FOOTER_SIZE:
                raise ValueError("BSIZE smaller than header+footer")
            return total
        p += 4 + slen
    raise ValueError("no BC subfield in extra field")
