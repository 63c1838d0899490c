"""Literal-only dynamic-Huffman DEFLATE on the device (kernel W2).

The device alternative to the canonical zlib-6 deflate of
``bgzf/codec.py``, behind ``DisqOptions.device_deflate`` /
``DISQ_TPU_TORCH_DEVICE_DEFLATE``. Its BGZF blocks are valid DEFLATE that
decompresses to the same bytes, but they are not the zlib-6 bytes, so the
route stays off by default.

- **No LZ77 matching.** Every byte is coded as a literal under one
  dynamic Huffman table, so the body encode is a per-byte table lookup,
  an exclusive scan of code lengths and a bit-pack.
- **Host, O(alphabet):** the byte histogram (counted on the device,
  256 counts back) → length-limited (≤15-bit) code by boundary
  package-merge, canonical codes, the RFC 1951 §3.2.7 dynamic
  header, and BGZF framing (CRC32, ISIZE). One table per call, so every
  block's header is the same ``header_bits`` long and every body starts
  at that bit offset.
- **Device, per byte:** ``encode`` launches W2 (``csrc/deflate.cu``) once
  over every payload of a call, one CTA per payload; on a CPU tensor it
  runs ``encode_plain``, the same arithmetic as torch ops. The body rows
  hold zero below ``header_bits``; the host ORs in the header and the
  end-of-block code.
- ``fetch`` brings the end bits back first, then the rows' occupied
  prefix only. A lane whose stream is no smaller than a stored block
  (``expanded``) is deflated again by host zlib-6, or stored when zlib
  expands it too.

The table decides the bytes, so the host code (package-merge and its
tie-breaks, canonical codes, header) is the reference's, line for line,
and the port's blocks are byte-identical to ``disq_tpu``'s.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from disq_tpu_torch.bgzf.block import BGZF_MAX_PAYLOAD as BLOCK_PAYLOAD
from disq_tpu_torch.bgzf.block import build_block_header
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import counter, device_span, span

_EOB = 256  # end-of-block symbol
_MAX_BITS = 15
_CL_MAX_BITS = 7
_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
# bits a header may take (the RFC worst case is ~3,700): the rows' bound
_HEADER_ALLOWANCE = 4096

#: The last ``deflate_blob_device`` call: blocks written, lanes the
#: coder expanded that host zlib deflated again (``host_fallback``), and
#: of those the ones zlib expanded too and stored (``stored_fallback``).
last_stats = {"blocks": 0, "stored_fallback": 0, "host_fallback": 0}

#: Device work of the process: W2 launches, LUT uploads, device-coded
#: blocks. With the knob off every entry stays 0.
device_stats = {"launches": 0, "lut_uploads": 0, "device_blocks": 0}


# -- host: length-limited Huffman (boundary package-merge) -------------------


def limited_huffman_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Exact optimal length-limited code lengths (package-merge); zero
    for absent symbols. The code is complete (Kraft sum 1) for ≥2
    present symbols, as zlib's inflate requires of a literal code."""
    freqs = np.asarray(freqs, dtype=np.int64)
    present = np.nonzero(freqs > 0)[0]
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if len(present) == 0:
        return lengths
    if len(present) == 1:
        lengths[present[0]] = 1
        return lengths
    if len(present) > (1 << limit):
        raise ValueError(f"{len(present)} symbols cannot fit in {limit} bits")
    # `limit` rounds of (sort, pair) over the original items; the first
    # 2n-2 items of the final list, counted by symbol multiplicity, give
    # each symbol's code length
    items = sorted((int(freqs[s]), (int(s),)) for s in present)
    packages: List[Tuple[int, Tuple[int, ...]]] = []
    for _ in range(limit):
        merged = sorted(packages + items)
        packages = [
            (merged[i][0] + merged[i + 1][0], merged[i][1] + merged[i + 1][1])
            for i in range(0, len(merged) - 1, 2)
        ]
    for _, syms in packages[: 2 * len(present) - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 §3.2.2 canonical code assignment from bit lengths."""
    lengths = np.asarray(lengths)
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros(len(lengths), dtype=np.int64)
    for s in range(len(lengths)):
        n = int(lengths[s])
        if n:
            codes[s] = next_code[n]
            next_code[n] += 1
    return codes


def _reverse_bits(v: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Huffman codes go MSB-first into DEFLATE's LSB-first stream, that
    is bit-reversed."""
    out = np.zeros_like(v)
    vv = v.copy()
    maxb = int(nbits.max()) if nbits.size else 0
    for _ in range(maxb):
        out = (out << 1) | (vv & 1)
        vv >>= 1
    # codes shorter than maxb were over-rotated; shift back
    return out >> (maxb - nbits)


class _BitWriter:
    """LSB-first bit accumulator (the header's bits)."""

    def __init__(self) -> None:
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int) -> None:
        self.acc |= value << self.nbits
        self.nbits += nbits

    def write_code(self, code: int, nbits: int) -> None:
        rev = 0
        for _ in range(nbits):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        self.write(rev, nbits)


def _rle_code_lengths(all_lens: np.ndarray) -> List[Tuple[int, int]]:
    """RFC 1951 §3.2.7 run-length encoding of the code-length sequence:
    (symbol, extra-bits value) pairs over the alphabet 0..18."""
    out: List[Tuple[int, int]] = []
    i, n = 0, len(all_lens)
    while i < n:
        v = int(all_lens[i])
        j = i
        while j < n and int(all_lens[j]) == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                out.append((18, r - 11))
                run -= r
            while run >= 3:
                r = min(run, 10)
                out.append((17, r - 3))
                run -= r
            out += [(0, -1)] * run
        else:
            out.append((v, -1))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                out.append((16, r - 3))
                run -= r
            out += [(v, -1)] * run
        i = j
    return out


def build_dynamic_header(lit_lens: np.ndarray, dist_lens: np.ndarray
                         ) -> Tuple[int, int]:
    """BFINAL, BTYPE and the dynamic table header → (bits value, nbits),
    LSB-first."""
    w = _BitWriter()
    w.write(1, 1)   # BFINAL: every BGZF block is one final block
    w.write(2, 2)   # BTYPE=10, dynamic
    hlit = len(lit_lens) - 257
    hdist = len(dist_lens) - 1
    seq = _rle_code_lengths(np.concatenate([lit_lens, dist_lens]))
    cl_freq = np.zeros(19, dtype=np.int64)
    for sym, _ in seq:
        cl_freq[sym] += 1
    cl_lens = limited_huffman_lengths(cl_freq, _CL_MAX_BITS)
    cl_codes = canonical_codes(cl_lens)
    hclen_lens = [int(cl_lens[s]) for s in _CL_ORDER]
    hclen = len(hclen_lens)
    while hclen > 4 and hclen_lens[hclen - 1] == 0:
        hclen -= 1
    w.write(hlit, 5)
    w.write(hdist, 5)
    w.write(hclen - 4, 4)
    for k in range(hclen):
        w.write(hclen_lens[k], 3)
    for sym, extra in seq:
        w.write_code(int(cl_codes[sym]), int(cl_lens[sym]))
        if sym == 16:
            w.write(extra, 2)
        elif sym == 17:
            w.write(extra, 3)
        elif sym == 18:
            w.write(extra, 7)
    return w.acc, w.nbits


class DeflateTable:
    """One shared dynamic-Huffman literal table: the package-merge and
    the header, done once per call on the host, and the code and length
    LUTs (256 int32 each), uploaded once to each device that encodes
    under the table. ``out_bytes`` is the body rows' width: room for the
    header allowance plus a full payload at the longest literal code,
    rounded up to 16 bytes for the kernel's vector stores."""

    __slots__ = ("lit_lens", "header_bits", "header_bytes", "eob_rev",
                 "eob_len", "max_code", "out_bytes", "_rev", "_luts",
                 "_lock")

    def __init__(self, freq: np.ndarray, eob_count: int) -> None:
        with span("device.deflate.table"):
            self._build(freq, eob_count)

    def _build(self, freq: np.ndarray, eob_count: int) -> None:
        lit_freq = np.concatenate(
            [np.asarray(freq, np.int64), [max(1, int(eob_count))]])
        self.lit_lens = limited_huffman_lengths(lit_freq, _MAX_BITS)
        # a literal plus the EOB: the ≥2 symbols zlib's decoder requires
        assert np.count_nonzero(self.lit_lens) >= 2
        lit_codes = canonical_codes(self.lit_lens)
        dist_lens = np.array([1], np.int32)  # one 1-bit distance code
        acc, nbits = build_dynamic_header(self.lit_lens, dist_lens)
        assert nbits < _HEADER_ALLOWANCE
        self.header_bits = nbits
        self.header_bytes = acc.to_bytes((nbits + 7) // 8, "little")
        self._rev = _reverse_bits(lit_codes, self.lit_lens)
        self.eob_rev = int(self._rev[_EOB])
        self.eob_len = int(self.lit_lens[_EOB])
        self.max_code = int(self.lit_lens[:256].max())
        ob = (_HEADER_ALLOWANCE + BLOCK_PAYLOAD * self.max_code
              + _MAX_BITS) // 8 + 2
        self.out_bytes = (ob + 15) // 16 * 16
        self._luts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def luts(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (code, length) LUTs as int32 tensors on ``device``,
        uploaded once per device."""
        device = torch.device(device)
        with self._lock:
            luts = self._luts.get(device)
            if luts is None:
                from disq_tpu_torch.runtime.device_pipeline import upload

                luts = (upload(self._rev[:256].astype(np.int32), device),
                        upload(self.lit_lens[:256].astype(np.int32), device))
                counters.add_stats(device_stats, lut_uploads=1)
                self._luts[device] = luts
            return luts


def histogram(payload: torch.Tensor) -> np.ndarray:
    """The 256 byte counts of ``payload`` (int64), counted on its device:
    the table's input, exact whichever device counts it."""
    freq = torch.bincount(payload, minlength=256).cpu().numpy()
    if payload.is_cuda:
        counters.book_transfer("d2h", freq.nbytes)
    return freq.astype(np.int64)


def occupied_bytes(end_bit, out_bytes: int):
    """Bytes of a body row that ``encode`` defines for a lane ending at
    ``end_bit`` (scalar or array): through the end-of-block code's
    longest possible end, rounded up to 16 and capped at the row. Bytes
    from ``end_bit`` on are zero."""
    end = np.asarray(end_bit, np.int64)
    occ = ((end + _MAX_BITS + 7) // 8 + 15) // 16 * 16
    return np.minimum(occ, out_bytes)


# -- device: the body encode (W2) ---------------------------------------------

# lanes per step of the plain version: bounds its (lanes, 65280) temporaries
_PLAIN_LANES = 32


def encode_plain(payload: torch.Tensor, pay_off: torch.Tensor,
                 pay_len: torch.Tensor, code_lut: torch.Tensor,
                 len_lut: torch.Tensor, header_bits: int,
                 out_bytes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``encode``, the reference's arithmetic as
    torch ops: LUT gathers, an exclusive ``cumsum`` of code lengths from
    ``header_bits``, and three ``index_add_`` of each code's bytes into
    the rows (codes never share a bit, so add is OR). The whole row is
    defined: zero outside the codes."""
    dev = payload.device
    n = pay_off.numel()
    bodies = torch.zeros((n, out_bytes), dtype=torch.uint8, device=dev)
    end = torch.full((n,), header_bits, dtype=torch.int32, device=dev)
    code_lut = code_lut.to(torch.int64)
    len_lut = len_lut.to(torch.int64)
    for lo in range(0, n, _PLAIN_LANES):
        hi = min(n, lo + _PLAIN_LANES)
        lens_in = pay_len[lo:hi].to(torch.int64)
        width = int(lens_in.max()) if hi > lo else 0
        if width == 0:
            continue
        col = torch.arange(width, device=dev)
        valid = col[None, :] < lens_in[:, None]
        idx = (pay_off[lo:hi, None] + col[None, :]).clamp(
            max=max(payload.numel() - 1, 0))
        sym = torch.where(valid, payload[idx].to(torch.int64), 0)
        lens = torch.where(valid, len_lut[sym], 0)
        starts = header_bits + torch.cumsum(lens, dim=1) - lens
        v = torch.where(valid, code_lut[sym], 0) << (starts & 7)
        rows = torch.zeros((hi - lo) * out_bytes, dtype=torch.int32,
                           device=dev)
        base = (torch.arange(hi - lo, device=dev) * out_bytes)[:, None]
        for k in range(3):
            ids = (base + (starts >> 3) + k).reshape(-1)
            part = ((v >> (8 * k)) & 0xFF).to(torch.int32)
            rows.index_add_(0, ids, part.reshape(-1))
        bodies[lo:hi] = rows.view(hi - lo, out_bytes).to(torch.uint8)
        end[lo:hi] = (header_bits + lens.sum(dim=1)).to(torch.int32)
    return bodies, end


def _lib():
    from disq_tpu_torch.ops import cuda_build

    lib = cuda_build.load("deflate")
    if lib.disq_deflate_launch.argtypes is None:
        lib.disq_deflate_launch.restype = ctypes.c_int
        lib.disq_deflate_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
    return lib


def encode(payload: torch.Tensor, pay_off: torch.Tensor,
           pay_len: torch.Tensor, code_lut: torch.Tensor,
           len_lut: torch.Tensor, header_bits: int,
           out_bytes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Literal-code every payload (``payload[pay_off[i]:][:pay_len[i]]``,
    ≤ 65,280 bytes each) under one table: ``(bodies (n, out_bytes) u8,
    end bits (n,) int32)``. A lane's codes start at bit ``header_bits``
    of its row, bits below it are zero, and ``end[i]`` is the bit after
    its last code. On ``cuda`` one W2 launch covers every lane and
    defines the row's first ``occupied_bytes(end[i])`` bytes; on the CPU
    ``encode_plain`` defines whole rows."""
    dev = payload.device
    if payload.dtype != torch.uint8 or payload.dim() != 1 \
            or not payload.is_contiguous():
        raise ValueError(f"payload: want a contiguous 1-D uint8 tensor, got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    for name, t, dt in (("pay_off", pay_off, torch.int64),
                        ("pay_len", pay_len, torch.int32),
                        ("code_lut", code_lut, torch.int32),
                        ("len_lut", len_lut, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name}: want a contiguous 1-D {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if pay_len.numel() != pay_off.numel():
        raise ValueError("pay_off and pay_len differ in length")
    if code_lut.numel() != 256 or len_lut.numel() != 256:
        raise ValueError("the LUTs hold 256 entries")
    if out_bytes % 16 or not 0 <= header_bits < _HEADER_ALLOWANCE:
        raise ValueError(f"out_bytes {out_bytes} (a multiple of 16) or "
                         f"header_bits {header_bits} out of range")
    if dev.type == "cpu":
        return encode_plain(payload, pay_off, pay_len, code_lut, len_lut,
                            header_bits, out_bytes)
    if dev.type != "cuda":
        raise ValueError(f"deflate runs on cuda or cpu, not {dev}")
    n = pay_off.numel()
    bodies = torch.empty((n, out_bytes), dtype=torch.uint8, device=dev)
    end = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.disq_deflate_launch(
                payload.data_ptr(), pay_off.data_ptr(), pay_len.data_ptr(),
                code_lut.data_ptr(), len_lut.data_ptr(), header_bits,
                out_bytes, n, bodies.data_ptr(), end.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        from disq_tpu_torch.ops.cuda_build import check_launch

        check_launch("deflate", rc)
        counters.book_launch("deflate")
        counters.add_stats(device_stats, launches=1)
    return bodies, end


def encode_blocks(payload: torch.Tensor, nbytes: int, table: DeflateTable
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encode`` over a contiguous payload cut into BGZF blocks of
    65,280 bytes (the last one shorter)."""
    from disq_tpu_torch.runtime.device_pipeline import upload

    n_blocks = -(-nbytes // BLOCK_PAYLOAD)
    pay_off = np.arange(n_blocks, dtype=np.int64) * BLOCK_PAYLOAD
    pay_len = np.minimum(nbytes - pay_off, BLOCK_PAYLOAD).astype(np.int32)
    dev = payload.device
    return encode(payload, upload(pay_off, dev), upload(pay_len, dev),
                  *table.luts(dev), table.header_bits, table.out_bytes)


def fetch(bodies: torch.Tensor, end: torch.Tensor, table: DeflateTable
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The encoded lanes on the host: the end bits first, then only the
    rows' prefix that the longest lane occupies."""
    with device_span("device.kernel", kernel="deflate_simd",
                     lanes=end.numel()) as fence:
        end_h = fence.sync(end).cpu().numpy()
    need = (int(occupied_bytes(end_h.max(), table.out_bytes))
            if len(end_h) else 0)
    body_h = bodies[:, :need].cpu().numpy()
    if bodies.is_cuda:
        counters.book_transfer("d2h", end_h.nbytes + body_h.nbytes)
    return body_h, end_h


# -- host: finalize, fallback, framing ----------------------------------------


def frame_block(stream: bytes, payload) -> bytes:
    """A raw DEFLATE stream and its payload → one BGZF block."""
    bsize = 18 + len(stream) + 8
    if bsize > 0x10000:
        raise ValueError("compressed BGZF block exceeds 64 KiB")
    return (build_block_header(bsize) + stream
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


def _stored_stream(payload: bytes) -> bytes:
    """BTYPE=00 stored block: the incompressible data's escape hatch."""
    n = len(payload)
    return bytes([1]) + struct.pack("<HH", n, n ^ 0xFFFF) + payload


def finalize_stream(body_row: np.ndarray, end_bit: int,
                    table: DeflateTable) -> bytes:
    """One lane's raw DEFLATE stream: the row's bytes up to the end, with
    the shared header and the trailing EOB code ORed in (codes never
    share a bit, so OR is exact)."""
    total_bits = end_bit + table.eob_len
    stream = bytearray(body_row[: (total_bits + 7) // 8].tobytes())
    for k, hb in enumerate(table.header_bytes):
        stream[k] |= hb
    acc = table.eob_rev << (end_bit & 7)
    for k in range((table.eob_len + (end_bit & 7) + 7) // 8):
        if (end_bit >> 3) + k < len(stream):
            stream[(end_bit >> 3) + k] |= (acc >> (8 * k)) & 0xFF
    return bytes(stream)


def host_deflate_stream(payload) -> bytes:
    """Host route of an expanded lane: the canonical zlib-6 raw stream,
    or a stored block when zlib expands too."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
    s = c.compress(payload) + c.flush()
    if len(s) >= len(payload) + 5:
        counters.add_stats(last_stats, stored_fallback=1)
        return _stored_stream(bytes(payload))
    return s


def host_block(payload) -> bytes:
    """One complete BGZF block by the host route."""
    return frame_block(host_deflate_stream(payload), payload)


def expanded(stream: bytes, payload) -> bool:
    """True when the coded stream is no smaller than a stored block of
    the payload: the lane takes the host route."""
    return len(stream) >= len(payload) + 5


def finalize_chunk(bodies: np.ndarray, end: np.ndarray, table: DeflateTable,
                   payloads: Sequence, deliver, host_route) -> List[int]:
    """Every lane of one encode: finalize and frame the device-coded
    lanes through ``deliver(j, block)``, and hand the expanded lanes'
    indices to ``host_route(flagged)``, booked as host fallbacks
    (reason ``expanded``)."""
    flagged: List[int] = []
    n_dev = b_in = b_out = 0
    for j, p in enumerate(payloads):
        stream = finalize_stream(bodies[j], int(end[j]), table)
        if expanded(stream, p):
            flagged.append(j)
            continue
        block = frame_block(stream, p)
        n_dev += 1
        b_in += len(p)
        b_out += len(block)
        deliver(j, block)
    counters.add_stats(device_stats, device_blocks=n_dev)
    if n_dev:
        counter("device.deflate.blocks").inc(n_dev)
        counter("device.deflate.bytes_in").inc(b_in)
        counter("device.deflate.bytes_out").inc(b_out)
    if flagged:
        counters.add_stats(last_stats, host_fallback=len(flagged))
        counters.book_host_fallback("expanded", len(flagged))
        host_route(flagged)
    return flagged


def join_blocks(blocks: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    """(the blocks concatenated, per-block compressed sizes)."""
    return (b"".join(blocks),
            np.array([len(b) for b in blocks], dtype=np.int64))


def deflate_blob_device(blob, device) -> Tuple[bytes, np.ndarray]:
    """Deflate a payload into BGZF blocks (no terminator) with W2 on
    ``device``: (compressed bytes, per-block compressed sizes), the
    contract of ``bgzf/codec.deflate_blob``. The blob goes to the device
    once; one table from its histogram (counted there; EOB once per
    block) and one launch code every block; expanded lanes take the host
    route."""
    from disq_tpu_torch.runtime.device_pipeline import upload

    last_stats.update(blocks=0, stored_fallback=0, host_fallback=0)
    if not len(blob):
        return b"", np.zeros(0, dtype=np.int64)
    data = (blob if isinstance(blob, np.ndarray)
            else np.frombuffer(blob, dtype=np.uint8))
    n_blocks = -(-len(data) // BLOCK_PAYLOAD)
    payload = upload(data, torch.device(device))
    table = DeflateTable(histogram(payload), n_blocks)
    bodies, end = encode_blocks(payload, len(data), table)
    body_h, end_h = fetch(bodies, end, table)
    del bodies, end
    mv = memoryview(data)
    payloads = [mv[i * BLOCK_PAYLOAD: (i + 1) * BLOCK_PAYLOAD]
                for i in range(n_blocks)]
    blocks: List[bytes] = [b""] * n_blocks

    def host_route(flagged: List[int]) -> None:
        def one(j: int) -> None:
            blocks[j] = host_block(payloads[j])

        if len(flagged) > 2:
            from disq_tpu_torch.util import shared_host_pool

            list(shared_host_pool().map(one, flagged))
        else:
            for j in flagged:
                one(j)

    finalize_chunk(body_h, end_h, table, payloads, blocks.__setitem__,
                   host_route)
    counters.add_stats(last_stats, blocks=n_blocks)
    return join_blocks(blocks)
