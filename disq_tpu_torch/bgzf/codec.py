"""BGZF inflate/deflate.

Two inflate routes share this module's block framing:

- the host route (``inflate_blocks``): the threaded C++ batch inflater
  when built, else per-block zlib;
- the device route (``inflate_blocks_device``): the shard's compressed
  bytes go to the device once and the hand-written inflate kernel
  (``ops/inflate_simd.py``) writes every block straight to its final
  offset in one decoded device blob. The blob comes back to the host
  once for the CRC check (a ``codec.inflate.crc`` span inside the
  batch's ``codec.inflate.batch``) and the record scan, and stays on
  the device for the parse kernel. On ``cuda`` this is the read path's
  default.
  ``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy`` takes kernel B4
  (``ops/inflate.py``) instead, as the reference's ``legacy`` knob does:
  one 65,536-byte row per block, which comes back to the host, where
  the rows' prefixes are joined into the blob, CRC-checked, and the
  blob is uploaded once more for the parse kernel.
  ``DISQ_TPU_TORCH_DEVICE_SERVICE=1`` submits the shard's payloads to the
  cross-shard device service (``runtime/device_service.py``), which
  coalesces them with other shards' into B1 launches and hands the blob
  back as host bytes; it is uploaded once for the parse kernel.

**Canonical deflate pin**: raw DEFLATE, zlib level 6, memLevel 8,
default strategy — every BGZF byte this package writes by default uses
exactly these parameters, so writes are byte-identical to the
reference's. ``DisqOptions.device_deflate`` (env
``DISQ_TPU_TORCH_DEVICE_DEFLATE``) routes a storage's deflates to the
literal-Huffman device coder instead (``ops/deflate.py``, kernel W2):
valid BGZF that decompresses to the same bytes, byte-identical to the
reference's device coder, but not the zlib-6 bytes.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO, Sequence, Tuple

import numpy as np

from disq_tpu_torch.bgzf.block import (
    BGZF_EOF_MARKER,
    BGZF_FOOTER_SIZE,
    BGZF_HEADER_SIZE,
    BGZF_MAX_PAYLOAD,
    BgzfBlock,
    build_block_header,
    make_virtual_offset,
    parse_block_header,
)

CANONICAL_LEVEL = 6
CANONICAL_MEMLEVEL = 8


def inflate_block(data: bytes, offset: int = 0, verify_crc: bool = True) -> bytes:
    """Inflate one BGZF block whose header begins at ``offset``."""
    total = parse_block_header(data, offset)
    xlen = struct.unpack_from("<H", data, offset + 10)[0]
    hdr_len = 12 + xlen
    payload = data[offset + hdr_len: offset + total - BGZF_FOOTER_SIZE]
    crc, isize = struct.unpack_from("<II", data, offset + total - BGZF_FOOTER_SIZE)
    try:
        out = zlib.decompress(payload, wbits=-15, bufsize=isize or 1)
    except zlib.error as e:
        raise ValueError(f"corrupt DEFLATE stream in BGZF block: {e}") from e
    if len(out) != isize:
        raise ValueError(f"BGZF ISIZE mismatch: {len(out)} != {isize}")
    if verify_crc and zlib.crc32(out) != crc:
        raise ValueError("BGZF CRC mismatch")
    return out


def _block_arrays(data, blocks: Sequence[BgzfBlock], base: int):
    """(block offsets, header lengths, csizes, usizes) of ``blocks``
    within the staged buffer ``data`` (which starts at file offset
    ``base``); header length = 12 + XLEN, which varies across writers."""
    arr = np.frombuffer(data, dtype=np.uint8)
    off = np.array([b.pos - base for b in blocks], dtype=np.int64)
    csize = np.array([b.csize for b in blocks], dtype=np.int64)
    usize = np.array([b.usize for b in blocks], dtype=np.int64)
    xlen = arr[off + 10].astype(np.int64) | (arr[off + 11].astype(np.int64) << 8)
    return arr, off, 12 + xlen, csize, usize


def inflate_blocks(data: bytes, blocks: Sequence[BgzfBlock], base: int = 0,
                   verify_crc: bool = True, as_array: bool = True,
                   keep_device: bool = False):
    """Host route: inflate many blocks of a staged buffer into one uint8
    array (``bytes`` when ``as_array`` is false). ``base`` is the file
    offset of ``data[0]``. ``keep_device`` returns ``(blob, None)``: the
    host route leaves nothing on a device."""
    if not blocks:
        out = np.empty(0, dtype=np.uint8)
    else:
        from disq_tpu_torch.runtime.tracing import span

        with span("codec.inflate.batch", blocks=len(blocks)):
            out = _inflate_blocks(data, blocks, base, verify_crc)
    if not as_array:
        out = out.tobytes()
    return (out, None) if keep_device else out


def _inflate_blocks(data, blocks, base, verify_crc) -> np.ndarray:
    try:
        from disq_tpu_torch.native import inflate_blocks_native

        arr, off, hdr, csize, usize = _block_arrays(data, blocks, base)
        return inflate_blocks_native(arr, off, hdr, csize, usize,
                                     verify_crc=verify_crc)
    except ImportError:
        pass
    parts = [inflate_block(data, b.pos - base, verify_crc=verify_crc)
             for b in blocks]
    return np.frombuffer(b"".join(parts), dtype=np.uint8)


def inflate_blocks_device(data: bytes, blocks: Sequence[BgzfBlock],
                          base: int, device, verify_crc: bool = True,
                          keep_device: bool = False, as_array: bool = True,
                          to_columnar=None):
    """Device route: returns ``(host blob, device blob)``, the same
    decoded bytes on both sides, or ``(host blob, None)`` unless
    ``keep_device``: a caller that reads only the host bytes (the text
    formats) keeps no device copy, and the legacy and service routes
    upload nothing. The host blob is a uint8 array (``bytes`` when
    ``as_array`` is false). When the kernel flags blocks (nonzero status)
    or their CRCs do not match, raises ``FlaggedBlocksError`` (a
    ``ValueError``) with the first one's message, every bad block, and
    the batch's output, which the caller's salvage path keeps for the
    good blocks.

    ``to_columnar`` (``{"n_ref": …, "lo_u": …, "end_u": …}``) returns a
    device-backed ``ColumnarBatch`` of the records in ``[lo_u, end_u)``
    of the decoded bytes instead, parsed (kernel B2) where the inflate
    left them."""
    import torch

    if to_columnar is not None:
        return _to_columnar(data, blocks, base, device, verify_crc,
                            to_columnar)
    if not blocks:
        empty = np.empty(0, dtype=np.uint8)
        out = (empty, (torch.empty(0, dtype=torch.uint8, device=device)
                       if keep_device else None))
    else:
        from disq_tpu_torch.runtime.tracing import span

        with span("codec.inflate.batch", blocks=len(blocks)):
            out = _inflate_blocks_device(data, blocks, base, device,
                                         verify_crc, keep_device)
    if not as_array:
        out = (out[0].tobytes(), out[1])
    return out


def _to_columnar(data, blocks, base, device, verify_crc, spec):
    """``inflate_blocks_device(..., to_columnar=spec)``."""
    from disq_tpu_torch.bam.codec import scan_record_offsets
    from disq_tpu_torch.bam.columnar import ReadBatch
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    if not blocks:
        return ColumnarBatch.from_host(ReadBatch.empty())
    blob, blob_dev = inflate_blocks_device(data, blocks, base, device,
                                           verify_crc, keep_device=True)
    lo_u = int(spec.get("lo_u", 0))
    end_u = spec.get("end_u")
    end_u = len(blob) if end_u is None else int(end_u)
    records = blob[lo_u:end_u]
    return ColumnarBatch.from_blob(records, scan_record_offsets(records),
                                   blob_dev, n_ref=spec.get("n_ref"),
                                   origin=lo_u)


def _inflate_blocks_device(data, blocks, base, device, verify_crc,
                           keep_device):
    import torch

    from disq_tpu_torch.runtime import counters, device_service
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.runtime.errors import FlaggedBlocksError
    from disq_tpu_torch.runtime.tracing import span

    arr, off, hdr, csize, usize = _block_arrays(data, blocks, base)
    pay_off = off + hdr
    pay_len = csize - hdr - BGZF_FOOTER_SIZE
    blob_dev = None
    if legacy_inflate():
        blob, out_off, flagged = _inflate_legacy(arr, pay_off, pay_len, usize,
                                                 device)
    elif device_service.enabled():
        blob, out_off, flagged = _inflate_service(data, pay_off, pay_len,
                                                  usize, device)
    else:
        from disq_tpu_torch.ops.inflate_simd import inflate_payloads_device

        try:
            blob_dev, out_off = inflate_payloads_device(
                arr, pay_off, pay_len, usize, device)
            flagged = None
        except FlaggedBlocksError as e:
            blob_dev, out_off, flagged = e.blob_dev, e.out_off, e
        if blob_dev.is_cuda:
            with span("device.transfer", direction="d2h"):
                blob = blob_dev.cpu().numpy()
            counters.book_transfer("d2h", blob.nbytes)
        else:
            blob = blob_dev.numpy()
    bad = set(flagged.bad) if flagged is not None else set()
    crc_bad = []
    if verify_crc:
        with span("codec.inflate.crc", blocks=len(blocks)):
            crc_bad = _crc_failures(data, blocks, base, blob, out_off, bad)
    if bad or crc_bad:
        raise FlaggedBlocksError(
            str(flagged) if flagged is not None
            else f"BGZF CRC mismatch at block {crc_bad[0]}",
            sorted(bad.union(crc_bad)), blob=blob, blob_dev=blob_dev,
            out_off=out_off)
    if not keep_device:
        return blob, None
    if blob_dev is None:
        blob_dev = upload(blob, torch.device(device))
    return blob, blob_dev


def _inflate_service(data, pay_off, pay_len, usize, device):
    """A shard's payloads through the device service: (host blob, block
    output offsets, a ``FlaggedBlocksError`` naming the blocks that both
    B1 and host zlib rejected, else None)."""
    from disq_tpu_torch.runtime import device_service
    from disq_tpu_torch.runtime.errors import FlaggedBlocksError

    mv = memoryview(data)
    payloads = [mv[int(o): int(o) + int(n)] for o, n in zip(pay_off, pay_len)]
    sub = device_service.get_service(device).submit_inflate(
        payloads, [int(u) for u in usize])
    (blob, out_off), errors = sub.outcome()
    flagged = None
    if errors:
        i = min(errors)
        flagged = FlaggedBlocksError(
            f"device inflate failed at block {i}: {errors[i]}",
            sorted(errors), blob=blob, out_off=out_off)
    return blob, out_off, flagged


def legacy_inflate() -> bool:
    """``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy``: the device route decodes
    with kernel B4 instead of B1."""
    import os

    return os.environ.get("DISQ_TPU_TORCH_DEVICE_INFLATE",
                          "").lower() == "legacy"


def _inflate_legacy(arr, pay_off, pay_len, usize, device):
    """B4 on a shard's payloads: (host blob, block output offsets, the
    reference's ``FlaggedBlocksError`` when blocks were flagged, else
    None)."""
    from disq_tpu_torch.ops.inflate import check_meta, inflate_rows
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.errors import FlaggedBlocksError

    rows, meta = inflate_rows(arr, pay_off, pay_len, usize, device)
    blob, out_off = row_prefixes(rows, meta[:, 0])
    try:
        check_meta(meta)
    except FlaggedBlocksError as e:
        counters.book_host_fallback("flagged", len(e.bad))
        return blob, out_off, e
    return blob, out_off, None


def row_prefixes(rows: np.ndarray, sizes: np.ndarray):
    """Join the first ``sizes[i]`` bytes of each row of ``rows``:
    (joined uint8 array, (n+1) int64 offsets)."""
    out_off = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    chunk = 256  # rows per prefix-mask gather: ≤16 MiB of mask
    cols = np.arange(rows.shape[1])
    for lo in range(0, rows.shape[0], chunk):
        hi = min(lo + chunk, rows.shape[0])
        keep = cols < sizes[lo:hi, None]
        out[out_off[lo]: out_off[hi]] = rows[lo:hi][keep]
    return out, out_off


def _crc_failures(data, blocks, base, blob, offsets, skip) -> list:
    """The blocks (batch indices, those in ``skip`` left out) whose
    device-decoded bytes fail their BGZF footer's CRC, over zero-copy
    blob slices; big batches fan out over the shared pool
    (``zlib.crc32`` releases the GIL)."""

    def fails(i: int) -> bool:
        if i in skip:
            return False
        b = blocks[i]
        crc = struct.unpack_from(
            "<I", data, b.pos - base + b.csize - BGZF_FOOTER_SIZE)[0]
        return zlib.crc32(blob[int(offsets[i]): int(offsets[i + 1])]) != crc

    idx = range(len(blocks))
    if len(blocks) >= 32:
        from disq_tpu_torch.util import shared_host_pool

        flags = list(shared_host_pool().map(fails, idx))
    else:
        flags = [fails(i) for i in idx]
    return [i for i in idx if flags[i]]


def device_deflate_enabled(storage=None) -> bool:
    """True when the device write path is armed for ``storage``:
    ``DisqOptions.device_deflate`` or ``DISQ_TPU_TORCH_DEVICE_DEFLATE``."""
    opts = getattr(storage, "_options", None)
    if opts is not None and getattr(opts, "device_deflate", False):
        return True
    from disq_tpu_torch.runtime.debug import env_flag

    return env_flag("DISQ_TPU_TORCH_DEVICE_DEFLATE")


def deflate_device_for(storage):
    """Where ``storage``'s BGZF deflates run: None (the canonical host
    zlib) unless the device write path is armed, else the storage's
    device (``cuda`` unless it asked for another; without CUDA this
    raises)."""
    if not device_deflate_enabled(storage):
        return None
    from disq_tpu_torch.util import resolve_device

    return resolve_device(getattr(storage, "_device", None))


def deflate_blob_for(storage, blob) -> Tuple[bytes, np.ndarray]:
    """``deflate_blob`` routed by ``storage``'s knob."""
    return deflate_blob(blob, device=deflate_device_for(storage))


def deflate_blob(blob: bytes, device=None) -> Tuple[bytes, np.ndarray]:
    """Deflate a payload into BGZF blocks of ≤65280 payload bytes (no
    terminator); returns (compressed bytes, per-block compressed sizes)
    — the sizes make write-side virtual offsets plain array arithmetic.

    ``device`` None: the canonical zlib-6 blocks, native-threaded when
    built, else zlib on the shared pool (same bytes either way). A
    device: the literal-Huffman coder on it (``ops/deflate.py``); with
    the device service on, the 65,280-byte payload slices go to its
    deflate queue, where blocks of concurrently written shards share W2
    launches (and their chunk's table)."""
    if len(blob) == 0:
        return b"", np.zeros(0, dtype=np.int64)
    if device is not None:
        from disq_tpu_torch.runtime import device_service

        if device_service.enabled():
            mv = memoryview(blob)
            parts = device_service.get_service(device).submit_deflate(
                [mv[o: o + BGZF_MAX_PAYLOAD]
                 for o in range(0, len(blob), BGZF_MAX_PAYLOAD)]).result()
            return (b"".join(parts),
                    np.array([len(p) for p in parts], dtype=np.int64))
        from disq_tpu_torch.ops.deflate import deflate_blob_device

        return deflate_blob_device(blob, device)
    pay_off = np.arange(0, len(blob) + BGZF_MAX_PAYLOAD, BGZF_MAX_PAYLOAD,
                        dtype=np.int64)
    pay_off[-1] = len(blob)
    try:
        from disq_tpu_torch.native import deflate_blocks_native

        rows, sizes = deflate_blocks_native(blob, pay_off,
                                            level=CANONICAL_LEVEL)
        return row_prefixes(rows, sizes)[0].tobytes(), sizes.astype(np.int64)
    except ImportError:
        pass
    from disq_tpu_torch.util import shared_host_pool

    mv = memoryview(blob)
    parts = list(shared_host_pool().map(
        lambda i: deflate_block(mv[int(pay_off[i]): int(pay_off[i + 1])]),
        range(len(pay_off) - 1)))
    return b"".join(parts), np.array([len(p) for p in parts], dtype=np.int64)


def deflate_block(payload) -> bytes:
    """Payload (≤65280 bytes) → one complete canonical BGZF block."""
    if len(payload) > BGZF_MAX_PAYLOAD:
        raise ValueError(f"payload too large for one BGZF block: {len(payload)}")
    c = zlib.compressobj(CANONICAL_LEVEL, zlib.DEFLATED, -15, CANONICAL_MEMLEVEL)
    comp = c.compress(payload) + c.flush()
    total = BGZF_HEADER_SIZE + len(comp) + BGZF_FOOTER_SIZE
    if total > 0x10000:
        # incompressible worst case: store at level 0 (DEFLATE framing)
        c = zlib.compressobj(0, zlib.DEFLATED, -15, CANONICAL_MEMLEVEL)
        comp = c.compress(payload) + c.flush()
        total = BGZF_HEADER_SIZE + len(comp) + BGZF_FOOTER_SIZE
    return (
        build_block_header(total)
        + comp
        + struct.pack("<II", zlib.crc32(payload), len(payload))
    )


def compress_to_bgzf(data: bytes, with_terminator: bool = True,
                     device=None) -> bytes:
    """Whole buffer → BGZF bytes (blocks of ≤65280 payload); ``device``
    routes the deflate as in ``deflate_blob``."""
    comp, _ = deflate_blob(data, device=device)
    return comp + BGZF_EOF_MARKER if with_terminator else comp


def decompress_bgzf(data: bytes) -> bytes:
    """Whole BGZF buffer → decompressed bytes (walks the BSIZE chain)."""
    out = []
    pos = 0
    while pos < len(data):
        total = parse_block_header(data, pos)
        out.append(inflate_block(data, pos))
        pos += total
    return b"".join(out)


class BgzfWriter:
    """Streaming BGZF writer with virtual-offset tracking: buffers
    payload to 65280 bytes and emits canonical blocks;
    ``tell_virtual()`` is the virtual offset of the next byte."""

    def __init__(self, stream: BinaryIO, write_terminator: bool = True):
        self._stream = stream
        self._buf = bytearray()
        self._block_start = 0
        self._terminate = write_terminator
        self._closed = False

    def tell_virtual(self) -> int:
        return make_virtual_offset(self._block_start, len(self._buf))

    @property
    def compressed_bytes_written(self) -> int:
        return self._block_start

    def write(self, data: bytes) -> int:
        view = memoryview(data)
        while view:
            take = min(BGZF_MAX_PAYLOAD - len(self._buf), len(view))
            self._buf += view[:take]
            view = view[take:]
            if len(self._buf) == BGZF_MAX_PAYLOAD:
                self._flush_block()
        return len(data)

    def _flush_block(self) -> None:
        if not self._buf:
            return
        block = deflate_block(bytes(self._buf))
        self._stream.write(block)
        self._block_start += len(block)
        self._buf.clear()

    def flush(self) -> None:
        self._flush_block()

    def close(self) -> None:
        if self._closed:
            return
        self._flush_block()
        if self._terminate:
            self._stream.write(BGZF_EOF_MARKER)
        self._stream.flush()
        self._closed = True

    def __enter__(self) -> "BgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BgzfReader(io.RawIOBase):
    """Seekable decompressed view of a BGZF stream with virtual-offset
    seek; used by the header read and the record guesser."""

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self._block_start = 0
        self._next_block = 0
        self._ublock = b""
        self._upos = 0
        self._eof = False

    def _read_full(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._stream.read(n - len(out))
            if not chunk:
                break
            out += chunk
        return out

    def _load_block_at(self, file_offset: int) -> bool:
        self._stream.seek(file_offset)
        header = self._read_full(BGZF_HEADER_SIZE)
        if not header:
            self._eof = True
            self._ublock = b""
            self._upos = 0
            self._block_start = file_offset
            return False
        if len(header) < BGZF_HEADER_SIZE:
            raise ValueError(f"BGZF file ends mid-header at {file_offset}")
        total = parse_block_header(header)
        rest = self._read_full(total - BGZF_HEADER_SIZE)
        if len(rest) < total - BGZF_HEADER_SIZE:
            raise ValueError(f"BGZF file ends mid-block at {file_offset}")
        self._ublock = inflate_block(header + rest)
        self._upos = 0
        self._block_start = file_offset
        self._next_block = file_offset + total
        self._eof = False
        return True

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def tell_virtual(self) -> int:
        if self._upos == len(self._ublock) and not self._eof:
            # at the end of a block == the start of the next
            return make_virtual_offset(self._next_block, 0)
        return make_virtual_offset(self._block_start, self._upos)

    def seek_virtual(self, voffset: int) -> None:
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        if coffset != self._block_start or not self._ublock:
            if not self._load_block_at(coffset) and uoffset != 0:
                raise ValueError(f"virtual offset past EOF: {voffset:#x}")
        if uoffset > len(self._ublock):
            raise ValueError(f"uoffset beyond block: {voffset:#x}")
        self._upos = uoffset

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n != 0:
            if self._upos >= len(self._ublock):
                if self._eof or not self._load_block_at(self._next_block):
                    break
            avail = len(self._ublock) - self._upos
            take = avail if n < 0 else min(n, avail)
            out += self._ublock[self._upos: self._upos + take]
            self._upos += take
            if n > 0:
                n -= take
        return bytes(out)

    def read_exact(self, n: int) -> bytes:
        data = self.read(n)
        if len(data) != n:
            raise EOFError(f"wanted {n} bytes, got {len(data)}")
        return data
