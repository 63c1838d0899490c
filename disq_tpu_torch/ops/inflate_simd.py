"""Device raw-DEFLATE inflate of BGZF payloads (kernel B1).

``inflate(comp, pay_off, pay_len, out_off, total)`` decodes every
payload ``comp[pay_off[i] : pay_off[i] + pay_len[i]]`` into
``out[out_off[i] : out_off[i + 1]]`` and reports per block the bytes
written (``out_len``) and a status code:

  0 ok · 1 bad BTYPE · 2 stored LEN/NLEN mismatch · 3 bad Huffman code ·
  4 bad distance · 5 output overflow · 6 ran past the compressed
  payload · 7 code-length repeat overflow · 8 ISIZE mismatch

These are the reference's codes (``disq_tpu/ops/inflate_simd.py``) with
the reference's decoder rules: bit-serial canonical Huffman decode with
no completeness check on the code set, bits past the payload read as
zero and the stream counted as overrun once more than 8 bytes past its
end are consumed, distances over the output written so far or over
32 KiB rejected. Two differences follow from writing each block at its
final offset: a block's output capacity is its own ISIZE (a stream
decoding to more bytes reports 5 where the reference's shared lane
buffer may only see 8), and status 8 is set by the kernel itself.

On a CUDA tensor ``inflate`` launches the CUDA kernel
(``csrc/inflate.cu``: one warp per payload, table-driven Huffman decode,
warp-cooperative copies); on a CPU tensor it runs ``inflate_plain``, the
plain Python decoder below, which computes the same bytes and codes.

Both host sides stage their inputs the same way (``Staged``): packed
into a pinned arena (``ARENAS``, exclusive checkout, returned only once
the copy that read it completed) and copied up in one ``non_blocking``
copy on the caller's current stream.

- ``inflate_payloads_device``, the per-split route: one shard's
  payloads, one launch, the statuses checked; the blob stays on the
  device for the parse.
- ``launch_payloads`` / ``fetch_payloads``, the device service's
  (``runtime/device_service.py``): any payloads, decoded without a
  wait, an event recorded; the fetch waits on it and copies the blob,
  lengths and statuses back.
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from disq_tpu_torch.ops.inflate import (  # the RFC 1951 tables, shared with B4
    BAD_BTYPE, BAD_CODE, BAD_DIST, BAD_STORED, IN_OVERRUN, ISIZE_MISMATCH,
    OK, OUT_OVERFLOW, REPEAT_OVERFLOW, CLORDER as _CLORDER, DBASE as _DBASE,
    DEXT as _DEXT, FIXED_LENS as _FIXED_LENS, LBASE as _LBASE, LEXT as _LEXT,
    NDIST as _NDIST, NLIT as _NLIT,
)
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import (
    device_span,
    hbm_resident,
    observe_gauge,
    span,
)

STATUS_NAMES = (
    "ok", "bad BTYPE", "stored LEN mismatch", "bad Huffman code",
    "bad distance", "output overflow", "input overrun",
    "code-length repeat overflow", "ISIZE mismatch",
)

# Cumulative dispatch counts (callers snapshot before/after), updated
# under ``counters.add_stats``' lock: device_lanes = blocks decoded in
# the kernel; host_big = blocks routed to the host for size (always 0:
# every BGZF payload fits the kernel); host_fallback = blocks the kernel
# flagged, which the host re-inflates on the salvage path.
last_stats = {"device_lanes": 0, "host_big": 0, "host_fallback": 0}

_LB, _LX, _DB, _DX = (t.tolist() for t in (_LBASE, _LEXT, _DBASE, _DEXT))
_CLO = _CLORDER.tolist()


# -- the plain version ------------------------------------------------------


class _Bits:
    """LSB-first bit reader over a payload; bits past its end read as
    zero. ``pos`` counts consumed bits."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def peek(self, n: int) -> int:
        byte = self.pos >> 3
        v = int.from_bytes(self.buf[byte: byte + 4], "little")
        return (v >> (self.pos & 7)) & ((1 << n) - 1)

    def take(self, n: int) -> int:
        v = self.peek(n) if n else 0
        self.pos += n
        return v


def _canonical(lens) -> Tuple[List[int], List[int]]:
    """Per-length counts and the (length, symbol)-sorted symbol list of
    a canonical code (puff's ``construct``, without its completeness
    check — the reference kernel has none)."""
    cnt = [0] * 16
    for ln in lens:
        cnt[ln] += 1
    offs = [0] * 17
    for ln in range(1, 16):
        offs[ln + 1] = offs[ln] + cnt[ln]
    syms = [0] * offs[16]
    for s, ln in enumerate(lens):
        if ln:
            syms[offs[ln]] = s
            offs[ln] += 1
    return cnt, syms


def _decode(bits: _Bits, table, maxbits: int) -> Tuple[int, int]:
    """Canonical bit-serial decode of one symbol: (symbol, code length),
    or (-1, 0) when no code of up to ``maxbits`` bits matches."""
    cnt, syms = table
    v = bits.peek(maxbits)
    code = first = index = 0
    for ln in range(1, maxbits + 1):
        code |= (v >> (ln - 1)) & 1
        count = cnt[ln]
        if first <= code < first + count:
            return syms[index + code - first], ln
        index += count
        first = (first + count) << 1
        code <<= 1
    return -1, 0


_FIXED_LIT = _canonical(_FIXED_LENS[:_NLIT].tolist())
_FIXED_DIST = _canonical(_FIXED_LENS[_NLIT:].tolist())


def inflate_raw(payload: bytes, cap: int) -> Tuple[bytes, int]:
    """Decode one raw-DEFLATE payload into at most ``cap`` bytes; returns
    (bytes written, status). The steps — header, stored LEN, NLEN, each
    stored chunk up to the next 4-byte output boundary, each code-length
    code, each symbol with its extra bits, each distance — are the
    reference kernel's; after each, a stream that has consumed more
    than 8 bytes past its end reports 6, over any other fault of that
    step."""
    bits = _Bits(bytes(payload))
    out = bytearray()
    limit = (len(payload) + 8) * 8
    status = OK
    if len(payload):
        status = _inflate_stream(bits, out, cap, limit)
    if status == OK and len(out) != cap:
        status = ISIZE_MISMATCH
    return bytes(out), status


def _inflate_stream(bits: _Bits, out: bytearray, cap: int, limit: int) -> int:
    while True:
        hdr = bits.take(3)
        bfinal, btype = hdr & 1, hdr >> 1
        if btype == 0:
            bits.pos += (-bits.pos) & 7
        if bits.pos > limit:
            return IN_OVERRUN
        if btype == 3:
            return BAD_BTYPE
        if btype == 0:
            status = _stored(bits, out, cap, limit)
        else:
            if btype == 1:
                lit, dist = _FIXED_LIT, _FIXED_DIST
            else:
                tables = _dynamic_tables(bits, limit)
                if isinstance(tables, int):
                    return tables
                lit, dist = tables
            status = _codes(bits, out, cap, limit, lit, dist)
        if status != OK:
            return status
        if bfinal:
            return OK


def _stored(bits: _Bits, out: bytearray, cap: int, limit: int) -> int:
    length = bits.take(16)
    if bits.pos > limit:
        return IN_OVERRUN
    nlen = bits.take(16)
    if bits.pos > limit:
        return IN_OVERRUN
    if nlen ^ 0xFFFF != length:
        return BAD_STORED
    while length:
        k = min(4 - (len(out) & 3), length)
        chunk = bits.take(8 * k)
        length -= k
        for j in range(k):
            if len(out) >= cap:
                return IN_OVERRUN if bits.pos > limit else OUT_OVERFLOW
            out.append((chunk >> (8 * j)) & 0xFF)
        if bits.pos > limit:
            return IN_OVERRUN
    return OK


def _dynamic_tables(bits: _Bits, limit: int):
    """Read a dynamic block's code tables: (lit table, dist table), or a
    status code."""
    v = bits.take(14)
    if bits.pos > limit:
        return IN_OVERRUN
    hlit, hdist, hclen = (v & 31) + 257, ((v >> 5) & 31) + 1, ((v >> 10) & 15) + 4
    cl_lens = [0] * 19
    for i in range(hclen):
        cl_lens[_CLO[i]] = bits.take(3)
        if bits.pos > limit:
            return IN_OVERRUN
    cl = _canonical(cl_lens)
    total = hlit + hdist
    lens = [0] * (_NLIT + _NDIST)
    nread = prev = 0
    while nread < total:
        sym, nb = _decode(bits, cl, 7)
        if sym < 0:
            return BAD_CODE
        if sym <= 15:
            bits.pos += nb
            lens[nread] = prev = sym
            nread += 1
            if bits.pos > limit:
                return IN_OVERRUN
            continue
        bits.pos += nb
        if sym == 16:
            rep, val = 3 + bits.take(2), prev
        elif sym == 17:
            rep, val = 3 + bits.take(3), 0
        else:
            rep, val = 11 + bits.take(7), 0
        if bits.pos > limit:
            return IN_OVERRUN
        if sym == 16 and nread == 0:
            return REPEAT_OVERFLOW
        for _ in range(rep):
            if nread >= total:
                return REPEAT_OVERFLOW
            lens[nread] = prev = val
            nread += 1
    return _canonical(lens[:hlit]), _canonical(lens[hlit:total])


def _codes(bits: _Bits, out: bytearray, cap: int, limit: int,
           lit, dist) -> int:
    """Decode literal/length and distance symbols up to end-of-block."""
    while True:
        sym, nb = _decode(bits, lit, 15)
        if sym < 0:
            return BAD_CODE
        bits.pos += nb
        if sym < 256:
            if len(out) >= cap:
                return IN_OVERRUN if bits.pos > limit else OUT_OVERFLOW
            out.append(sym)
            if bits.pos > limit:
                return IN_OVERRUN
            continue
        if sym == 256:
            return IN_OVERRUN if bits.pos > limit else OK
        if sym > 285:
            return IN_OVERRUN if bits.pos > limit else BAD_CODE
        li = sym - 257
        length = _LB[li] + bits.take(_LX[li])
        if bits.pos > limit:
            return IN_OVERRUN
        dsym, nb = _decode(bits, dist, 15)
        if dsym < 0:
            return BAD_CODE
        bits.pos += nb
        if dsym > 29:
            return IN_OVERRUN if bits.pos > limit else BAD_CODE
        d = _DB[dsym] + bits.take(_DX[dsym])
        if bits.pos > limit:
            return IN_OVERRUN
        if d > len(out) or d > 32768:
            return BAD_DIST
        for _ in range(length):
            if len(out) >= cap:
                return OUT_OVERFLOW
            out.append(out[-d])


def inflate_plain(comp: torch.Tensor, pay_off: torch.Tensor,
                  pay_len: torch.Tensor, out_off: torch.Tensor, total: int):
    """The plain version of the kernel: ``inflate_raw`` per block on the
    host, results on the inputs' device."""
    data = comp.cpu().numpy().tobytes()
    po, pl, oo = (t.cpu().numpy() for t in (pay_off, pay_len, out_off))
    n = len(po)
    out = np.zeros(total, dtype=np.uint8)
    out_len = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int32)
    for i in range(n):
        lo, cap = int(oo[i]), int(oo[i + 1] - oo[i])
        got, status[i] = inflate_raw(data[po[i]: po[i] + pl[i]], cap)
        out[lo: lo + len(got)] = np.frombuffer(got, dtype=np.uint8)
        out_len[i] = len(got)
    dev = comp.device
    return (torch.from_numpy(out).to(dev), torch.from_numpy(out_len).to(dev),
            torch.from_numpy(status).to(dev))


# -- the kernel wrapper -----------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous() \
            or t.dim() != 1:
        raise ValueError(
            f"{name}: want a contiguous 1-D {dtype} tensor on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _lib():
    from disq_tpu_torch.ops import cuda_build

    lib = cuda_build.load("inflate")
    if lib.disq_inflate_launch.argtypes is None:
        lib.disq_inflate_launch.restype = ctypes.c_int
        lib.disq_inflate_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_void_p]
    return lib


def inflate(comp: torch.Tensor, pay_off: torch.Tensor, pay_len: torch.Tensor,
            out_off: torch.Tensor, total: int):
    """Decode payloads into one blob: returns ``(out uint8[total],
    out_len int32[n], status int32[n])``. ``out_off`` holds the n+1
    block output offsets and ``total == out_off[-1]``."""
    dev = comp.device
    _check("comp", comp, torch.uint8, dev)
    for name, t in (("pay_off", pay_off), ("pay_len", pay_len),
                    ("out_off", out_off)):
        _check(name, t, torch.int64, dev)
    n = pay_off.numel()
    if pay_len.numel() != n or out_off.numel() != n + 1:
        raise ValueError("pay_off, pay_len and out_off disagree on the "
                         "block count")
    if dev.type == "cpu":
        return inflate_plain(comp, pay_off, pay_len, out_off, total)
    if dev.type != "cuda":
        raise ValueError(f"inflate runs on cuda or cpu, not {dev}")
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.disq_inflate_launch(
                comp.data_ptr(), pay_off.data_ptr(), pay_len.data_ptr(),
                out_off.data_ptr(), out.data_ptr(), out_len.data_ptr(),
                status.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        from disq_tpu_torch.ops.cuda_build import check_launch

        check_launch("inflate", rc)
        counters.book_launch("inflate")
    return out, out_len, status


# -- host side of the device route ------------------------------------------


def inflate_payloads_device(data: np.ndarray, pay_off: np.ndarray,
                            pay_len: np.ndarray, usizes: np.ndarray, device):
    """Stage a shard's compressed bytes once (``Staged``), decode every
    payload into one device blob at its ISIZE-prefix-sum offset, and
    check the statuses; returns ``(device blob, out_off)``. A flagged
    block raises ``FlaggedBlocksError`` (a ``ValueError``) naming it,
    which carries the blob and the flagged blocks for the caller's
    salvage path."""
    device = torch.device(device)
    n = len(pay_off)
    out_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.asarray(usizes, dtype=np.int64), out=out_off[1:])
    # the call's working set: the staged bytes, the indexes and the blob
    with hbm_resident(len(data) + 8 * (4 * n + 1) + int(out_off[-1])):
        staged = Staged("inflate", [
            np.asarray(data, dtype=np.uint8),
            np.asarray(pay_off, dtype=np.int64),
            np.asarray(pay_len, dtype=np.int64), out_off], device)
        try:
            with device_span("device.kernel", kernel="inflate_simd",
                             lanes=n):
                blob, _out_len, status = inflate(*staged.tensors,
                                                 int(out_off[-1]))
                # the status d2h waits for the staged copy and the kernel
                st = status.cpu().numpy()
        finally:
            staged.release()
    if device.type == "cuda":
        counters.book_transfer("d2h", st.nbytes)
    bad = np.nonzero(st)[0]
    counters.add_stats(last_stats, device_lanes=n - len(bad),
                       host_fallback=len(bad))
    if len(bad):
        from disq_tpu_torch.runtime.errors import FlaggedBlocksError

        counters.book_host_fallback("flagged", len(bad))
        i = int(bad[0])
        raise FlaggedBlocksError(
            f"device inflate failed at block {i}: status {int(st[i])} "
            f"({STATUS_NAMES[int(st[i])]})", bad, blob_dev=blob,
            out_off=out_off)
    return blob, out_off


def host_inflate(payload, expect: int) -> bytes:
    """Host zlib of one raw-DEFLATE payload (the service's route for a
    lane the kernel flagged): a decode failure or a length other than
    ``expect`` raises ``ValueError``."""
    try:
        out = zlib.decompress(payload, wbits=-15, bufsize=max(1, expect))
    except zlib.error as e:
        raise ValueError(f"corrupt DEFLATE stream: {e}") from e
    if len(out) != expect:
        raise ValueError(f"device inflate failed: ISIZE {expect} != "
                         f"{len(out)}")
    return out


# -- staging arenas and the launch / fetch split ----------------------------


_ARENA_MIN = 1 << 20
_ALIGN = 16


class ArenaPool:
    """Checkout pool of host staging arenas (uint8 tensors, pinned for a
    card), keyed by (kind, pinned, capacity); capacities are powers of
    two of at least 1 MiB. A checkout is exclusive, and a caller returns
    an arena only after the copy that read it completed, so a
    ``non_blocking`` upload never reads a repacked arena. At most
    ``per_key_cap`` free arenas are kept per key; ``device.arena_bytes``
    is the resident total."""

    def __init__(self, per_key_cap: int = 4) -> None:
        self._lock = threading.Lock()
        self._free: Dict[Any, List[torch.Tensor]] = {}
        self._bytes = 0
        self._cap = per_key_cap

    def acquire(self, kind: str, nbytes: int, pinned: bool):
        """``(key, arena)``: a free arena of at least ``nbytes``."""
        cap = _ARENA_MIN
        while cap < nbytes:
            cap *= 2
        key = (kind, pinned, cap)
        with self._lock:
            free = self._free.get(key)
            if free:
                return key, free.pop()
        arena = torch.empty(cap, dtype=torch.uint8, pin_memory=pinned)
        with self._lock:
            self._bytes += cap
            total = self._bytes
        observe_gauge("device.arena_bytes", total)
        return key, arena

    def release(self, key, arena: torch.Tensor) -> None:
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self._cap:
                free.append(arena)
                return
            self._bytes -= arena.numel()
            total = self._bytes
        observe_gauge("device.arena_bytes", total)

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes


ARENAS = ArenaPool()


class Staged:
    """Host arrays packed into one arena and copied to ``device`` in one
    ``non_blocking`` copy on the current stream; ``tensors`` are typed
    views of the device copy (of the arena itself on the CPU). An entry
    may be a list of byte buffers, packed back to back as one uint8
    array. ``release()`` returns the arena: call it only after the copy
    completed (an event recorded after it, synchronized)."""

    def __init__(self, kind: str, arrays: Sequence, device) -> None:
        device = torch.device(device)
        spans, at = [], 0
        for a in arrays:
            n = (sum(len(p) for p in a) if isinstance(a, list) else a.nbytes)
            spans.append((at, n))
            at += -(-n // _ALIGN) * _ALIGN
        self.nbytes = at
        self._key, self._arena = ARENAS.acquire(kind, max(at, 1),
                                                device.type == "cuda")
        host = self._arena.numpy()
        for a, (lo, n) in zip(arrays, spans):
            if isinstance(a, list):
                o = lo
                for piece in a:
                    host[o: o + len(piece)] = np.frombuffer(piece,
                                                            dtype=np.uint8)
                    o += len(piece)
            elif n:
                host[lo: lo + n] = np.ascontiguousarray(a).reshape(-1) \
                    .view(np.uint8)
        if device.type == "cuda":
            counters.book_transfer("h2d", at)
            with span("device.transfer", direction="h2d"):
                buf = self._arena[:at].to(device, non_blocking=True)
        else:
            buf = self._arena[:at]
        self.tensors = []
        for a, (lo, n) in zip(arrays, spans):
            if isinstance(a, list):
                self.tensors.append(buf[lo: lo + n])
            else:
                dt = getattr(torch, np.dtype(a.dtype).name)
                self.tensors.append(buf[lo: lo + n].view(dt).view(a.shape))

    def release(self) -> None:
        if self._arena is not None:
            ARENAS.release(self._key, self._arena)
            self._arena = None


def record_event(device) -> Optional["torch.cuda.Event"]:
    """An event recorded on ``device``'s current stream (None on the
    CPU, where the work already ran)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class PayloadLaunch:
    """One ``launch_payloads`` in flight: its staged inputs, outputs and
    the event after them."""

    __slots__ = ("staged", "outputs", "event", "out_off", "n")

    def __init__(self, staged, outputs, event, out_off, n) -> None:
        self.staged, self.outputs, self.event = staged, outputs, event
        self.out_off, self.n = out_off, n


def launch_payloads(payloads: Sequence, expects: Sequence[int],
                    device) -> PayloadLaunch:
    """Stage raw-DEFLATE ``payloads`` in a pinned arena and enqueue the
    copy and B1 on the current stream without waiting; block ``i``
    decodes to ``expects[i]`` bytes at its prefix-sum offset."""
    n = len(payloads)
    pay_len = np.fromiter((len(p) for p in payloads), np.int64, n)
    pay_off = np.zeros(n, dtype=np.int64)
    np.cumsum(pay_len[:-1], out=pay_off[1:])
    out_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.asarray(expects, dtype=np.int64), out=out_off[1:])
    staged = Staged("inflate", [list(payloads), pay_off, pay_len, out_off],
                    device)
    try:
        outputs = inflate(*staged.tensors, int(out_off[-1]))
        event = record_event(device)
    except BaseException:
        staged.release()
        raise
    return PayloadLaunch(staged, outputs, event, out_off, n)


def fetch_payloads(handle: PayloadLaunch):
    """Wait for a ``launch_payloads`` and bring its outputs back:
    ``(blob, out_len, status, out_off)`` on the host."""
    out, out_len, status = handle.outputs
    with device_span("device.kernel", kernel="inflate_simd",
                     lanes=handle.n):
        if handle.event is not None:
            handle.event.synchronize()
    handle.staged.release()
    host = [t.cpu().numpy() for t in (out, out_len, status)]
    if out.is_cuda:
        counters.book_transfer("d2h", sum(a.nbytes for a in host))
    handle.outputs = None
    return (*host, handle.out_off)
