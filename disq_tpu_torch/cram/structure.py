"""CRAM 3.0 container / block structures.

Reference parity: htsjdk's ``Container``/``Block``/``CramHeader`` +
``CramContainerHeaderIterator`` (used by disq's ``CramSource``,
SURVEY.md §2.5). Layout per the CRAM 3.0 specification:

- file: magic ``CRAM`` + major.minor + 20-byte file id, then containers,
  ending with the fixed EOF container.
- container header: length i32 · ref_seq_id ITF8 · ref_start ITF8 ·
  ref_span ITF8 · n_records ITF8 · record_counter LTF8 · bases LTF8 ·
  n_blocks ITF8 · landmarks ITF8[] · crc32 u32.
- block: method u8 (0 raw · 1 gzip · 4 rans4x8) · content_type u8 ·
  content_id ITF8 · comp_size ITF8 · raw_size ITF8 · data · crc32 u32.

Reading a block is two steps: ``StoredBlock.read`` parses and
CRC-checks it, ``StoredBlock.decompress`` decodes it. A CRAM split
parses all its blocks first, so that it can decode every order-0 rANS
stream among them in one device launch; ``Block.read`` does both steps
for one block.
"""

from __future__ import annotations

import gzip as _gzip
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from disq_tpu_torch.cram.io import Cursor, write_itf8, write_ltf8
from disq_tpu_torch.cram.rans import rans_decode, rans_encode_order0

CRAM_MAGIC = b"CRAM"
CRAM_VERSION = (3, 0)

# Block compression methods
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
# Block content types
FILE_HEADER, COMPRESSION_HEADER, MAPPED_SLICE, EXTERNAL, CORE = 0, 1, 2, 4, 5

# The fixed 38-byte EOF container (CRAM 3.0 spec §9; byte-for-byte).
EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "000100ee63014b"
)


def file_definition(file_id: bytes = b"\x00" * 20) -> bytes:
    assert len(file_id) == 20
    return CRAM_MAGIC + bytes(CRAM_VERSION) + file_id


def read_file_definition(data, offset: int = 0) -> Tuple[Tuple[int, int], int]:
    if bytes(data[offset:offset + 4]) != CRAM_MAGIC:
        raise ValueError("not a CRAM file (bad magic)")
    major, minor = data[offset + 4], data[offset + 5]
    if major != 3:
        raise ValueError(f"unsupported CRAM version {major}.{minor} (need 3.x)")
    return (major, minor), offset + 26


@dataclass
class Block:
    content_type: int
    content_id: int
    data: bytes                  # raw (uncompressed) content
    method: int = RAW            # method to use when serializing
    rans_order: int = 0          # RANS method: 0 or 1 (order-1 for QS)

    def to_bytes(self) -> bytes:
        if self.method == RAW:
            comp = self.data
        elif self.method == GZIP:
            comp = _gzip.compress(self.data, compresslevel=6, mtime=0)
        elif self.method == RANS:
            if self.rans_order == 1:
                from disq_tpu_torch.cram.rans import rans_encode_order1

                comp = rans_encode_order1(self.data)
            else:
                comp = rans_encode_order0(self.data)
        else:
            raise ValueError(f"unsupported write method {self.method}")
        body = (
            bytes([self.method, self.content_type])
            + write_itf8(self.content_id)
            + write_itf8(len(comp))
            + write_itf8(len(self.data))
            + comp
        )
        return body + struct.pack("<I", zlib.crc32(body))

    @classmethod
    def read(cls, cur: Cursor) -> "Block":
        return StoredBlock.read(cur).decompress()


@dataclass
class StoredBlock:
    """A block as stored: its header fields and compressed bytes, after
    the CRC check and before decompression."""

    method: int
    content_type: int
    content_id: int
    raw_size: int
    comp: bytes

    @classmethod
    def read(cls, cur: Cursor) -> "StoredBlock":
        start = cur.off
        method = cur.u8()
        content_type = cur.u8()
        content_id = cur.itf8()
        comp_size = cur.itf8()
        raw_size = cur.itf8()
        comp = cur.bytes(comp_size)
        body = bytes(cur.data[start:cur.off])
        (crc,) = struct.unpack("<I", cur.bytes(4))
        if zlib.crc32(body) != crc:
            raise ValueError("CRAM block CRC mismatch")
        return cls(method, content_type, content_id, raw_size, comp)

    @property
    def is_rans0(self) -> bool:
        """An order-0 rANS stream with something to decode — what the
        device route decodes."""
        return (self.method == RANS and len(self.comp) >= 9
                and self.comp[0] == 0
                and struct.unpack_from("<I", self.comp, 5)[0] > 0)

    def decompress(self, decoded: Optional[bytes] = None) -> Block:
        """The decoded block. ``decoded`` is this block's rANS stream
        already decoded (by the split's device launch); otherwise the
        host codec decodes it."""
        method, comp = self.method, self.comp
        try:
            if decoded is not None:
                data = decoded
            elif method == RAW:
                data = comp
            elif method == GZIP:
                data = _gzip.decompress(comp)
            elif method == RANS:
                data = rans_decode(comp)
            elif method == BZIP2:
                import bz2

                data = bz2.decompress(comp)
            elif method == LZMA:
                import lzma

                data = lzma.decompress(comp)
            else:
                raise ValueError(f"unsupported CRAM block method {method}")
        except ValueError:
            raise
        except Exception as e:   # zlib.error / OSError / LZMAError ...
            raise ValueError(
                f"corrupt CRAM block body (method {method}): {e}") from e
        if len(data) != self.raw_size:
            raise ValueError("CRAM block raw size mismatch")
        return Block(self.content_type, self.content_id, data, method)


@dataclass
class ContainerHeader:
    length: int          # byte length of all blocks in the container
    ref_seq_id: int
    ref_start: int
    ref_span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: List[int]

    def to_bytes(self) -> bytes:
        body = (
            struct.pack("<i", self.length)
            + write_itf8(self.ref_seq_id)
            + write_itf8(self.ref_start)
            + write_itf8(self.ref_span)
            + write_itf8(self.n_records)
            + write_ltf8(self.record_counter)
            + write_ltf8(self.bases)
            + write_itf8(self.n_blocks)
            + write_itf8(len(self.landmarks))
            + b"".join(write_itf8(x) for x in self.landmarks)
        )
        return body + struct.pack("<I", zlib.crc32(body))

    @classmethod
    def read(cls, cur: Cursor) -> "ContainerHeader":
        start = cur.off
        length = cur.i32()
        ref_seq_id = cur.itf8()
        ref_start = cur.itf8()
        ref_span = cur.itf8()
        n_records = cur.itf8()
        record_counter = cur.ltf8()
        bases = cur.ltf8()
        n_blocks = cur.itf8()
        landmarks = cur.itf8_array()
        body = bytes(cur.data[start:cur.off])
        (crc,) = struct.unpack("<I", cur.bytes(4))
        if zlib.crc32(body) != crc:
            raise ValueError("CRAM container header CRC mismatch")
        return cls(
            length, ref_seq_id, ref_start, ref_span, n_records,
            record_counter, bases, n_blocks, landmarks,
        )

    @property
    def is_eof(self) -> bool:
        return self.n_records == 0 and self.ref_seq_id == -1 and self.length == 15


@dataclass
class SliceHeader:
    ref_seq_id: int
    ref_start: int
    ref_span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int = -1
    md5: bytes = b"\x00" * 16

    def to_bytes(self) -> bytes:
        return (
            write_itf8(self.ref_seq_id)
            + write_itf8(self.ref_start)
            + write_itf8(self.ref_span)
            + write_itf8(self.n_records)
            + write_ltf8(self.record_counter)
            + write_itf8(self.n_blocks)
            + write_itf8(len(self.content_ids))
            + b"".join(write_itf8(x) for x in self.content_ids)
            + write_itf8(self.embedded_ref_id)
            + self.md5
        )

    @classmethod
    def parse(cls, data: bytes) -> "SliceHeader":
        cur = Cursor(data)
        ref_seq_id = cur.itf8()
        ref_start = cur.itf8()
        ref_span = cur.itf8()
        n_records = cur.itf8()
        record_counter = cur.ltf8()
        n_blocks = cur.itf8()
        content_ids = cur.itf8_array()
        embedded = cur.itf8()
        md5 = cur.bytes(16)
        return cls(
            ref_seq_id, ref_start, ref_span, n_records, record_counter,
            n_blocks, content_ids, embedded, md5,
        )


def read_container_header_at(
    fs, path: str, pos: int, file_length: int
) -> Tuple[ContainerHeader, int]:
    """Read one container header at ``pos`` → (header, header byte size).
    Retries with a doubled window when a header (e.g. one with many
    landmarks in a multi-slice container) exceeds the initial read."""
    want = 256
    while True:
        data = fs.read_range(path, pos, min(want, file_length - pos))
        cur = Cursor(data)
        try:
            hdr = ContainerHeader.read(cur)
            return hdr, cur.off
        except (IndexError, ValueError, struct.error):
            if want >= file_length - pos:
                raise
            want *= 4


def walk_container_offsets(fs, path: str, retrier=None, ctx=None
                           ) -> List[Tuple[int, ContainerHeader]]:
    """Enumerate (offset, header) of every container by reading headers
    and skipping payloads — htsjdk's ``CramContainerHeaderIterator``
    walk, run before the splits are planned. Seek-dominated.

    ``retrier`` (a ``runtime.errors.ShardRetrier``) retries each header
    read on its own: one read per container, so a whole-walk retry
    would never converge under a sustained transient fault rate.

    A container header that does not parse, or claims a negative length,
    is corrupt. With ``ctx`` (a ``ShardErrorContext``) it goes to the
    policy: strict raises ``CorruptBlockError`` with its offset; skip
    and quarantine count one ``"CRAM container header"`` unit and stop
    the walk there (CRAM has no re-sync point past a broken length, so
    the containers beyond it are unreachable). Without ``ctx`` it raises
    ``CorruptBlockError``."""
    from disq_tpu_torch.runtime.errors import corrupt, is_transient

    def to_policy(e: BaseException, pos: int) -> None:
        if ctx is None:
            raise corrupt(e, kind="CRAM container header", path=path,
                          shard_id=-1, block_offset=pos) from e
        ctx.handle_corrupt_block(e, block_offset=pos,
                                 kind="CRAM container header")

    length = fs.get_file_length(path)
    out: List[Tuple[int, ContainerHeader]] = []
    # File definition is 26 bytes.
    pos = 26
    while pos < length:
        try:
            if retrier is not None:
                hdr, hdr_size = retrier.call(
                    read_container_header_at, fs, path, pos, length,
                    what="container_header")
            else:
                hdr, hdr_size = read_container_header_at(fs, path, pos,
                                                         length)
        except Exception as e:  # noqa: BLE001 — classified below
            if is_transient(e):
                raise
            to_policy(e, pos)
            break
        if hdr.length < 0:
            # A garbage length would walk pos backwards (or loop):
            # classify as corrupt rather than spin.
            to_policy(ValueError(
                f"container at {pos} claims negative length {hdr.length}"),
                pos)
            break
        out.append((pos, hdr))
        pos += hdr_size + hdr.length
        if hdr.is_eof:
            break
    return out
