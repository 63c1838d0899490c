"""rANS 4x8 codec (CRAM 3.0 §13: rANS order-0 and order-1).

Replaces htsjdk's ``RANSExternalCompressor``/rANS codec classes. Stream
layout (matching htslib's rANS_static):

    order u8 · comp_size u32le · raw_size u32le · frequency table ·
    4 interleaved rANS states (u32le each) · renormalization bytes

Constants: 12-bit frequency precision (sum 4096), lower bound 1<<23,
byte-wise renormalization, 4 states round-robin over output positions.

Order 0 and order 1 are both implemented for encode and decode. The
writer emits order-1 for quality scores (the htslib QS default;
``DISQ_TPU_TORCH_CRAM_RANS_O1=0`` makes them order-0). Both encoders
have native C fast paths byte-identical to the Python implementations.

``rans_decode`` decodes one stream on the host. The device route is
``rans0_decode_streams``: every order-0 stream of a CRAM split in one
launch of kernel B3, or of B5 under ``DISQ_TPU_TORCH_DEVICE_RANS=legacy``;
on the CPU it runs the kernels' plain versions. With
``DISQ_TPU_TORCH_DEVICE_SERVICE=1`` a split's streams are one submission
to the device service, so the splits in flight share B3 launches.
Order-1 always decodes on the host, as in the reference, which has no
device kernel for it.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import span

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT      # 4096
RANS_LOW = 1 << 23


# -- frequency tables -------------------------------------------------------

def _normalize_freqs(counts: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Scale symbol counts to sum exactly ``total``, every present symbol
    keeping freq >= 1."""
    n = counts.sum()
    if n == 0:
        return counts.astype(np.int64)
    f = counts.astype(np.float64) * total / n
    out = np.floor(f).astype(np.int64)
    out[(counts > 0) & (out == 0)] = 1
    # Adjust to hit the exact total: add/remove from the largest symbols.
    # Stable sort (ties by symbol index) so the native C++ codec can
    # reproduce the same table byte-for-byte.
    diff = total - out.sum()
    order = np.argsort(-out, kind="stable")
    i = 0
    while diff != 0:
        s = order[i % len(order)]
        if out[s] > 0 or diff > 0:
            step = 1 if diff > 0 else -1
            if out[s] + step >= 1 or counts[s] == 0:
                out[s] += step
                diff -= step
        i += 1
    return out


def _write_freq_table0(freqs: np.ndarray) -> bytes:
    out = bytearray()
    syms = np.nonzero(freqs)[0]
    rle = 0
    for idx, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(int(s))
            if idx > 0 and s == syms[idx - 1] + 1:
                # count run of consecutive symbols following s
                run = 0
                while idx + run + 1 < len(syms) and syms[idx + run + 1] == s + run + 1:
                    run += 1
                out.append(run)
                rle = run
        f = int(freqs[s])
        if f < 128:
            out.append(f)
        else:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)
    return bytes(out)


def _read_freq_table0(data, off: int) -> Tuple[np.ndarray, int]:
    freqs = np.zeros(256, dtype=np.int64)
    rle = 0
    sym = data[off]
    off += 1
    last = -2
    while True:
        f = data[off]
        off += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | data[off]
            off += 1
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            last = sym
            sym = sym + 1
            continue
        last = sym
        nxt = data[off]
        off += 1
        if nxt == 0:
            break
        if nxt == last + 1:
            rle = data[off]
            off += 1
        sym = nxt
    return freqs, off


# -- order-0 encode ---------------------------------------------------------

def rans_encode_order0(raw: bytes) -> bytes:
    try:
        from disq_tpu_torch.native import rans_encode0_native

        return rans_encode0_native(raw)
    except ImportError:
        pass
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return struct.pack("<BII", 0, 0, 0)
    counts = np.bincount(data, minlength=256)
    freqs = _normalize_freqs(counts)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    table = _write_freq_table0(freqs)

    states = [RANS_LOW] * 4
    out_rev = bytearray()  # renorm bytes, reversed at the end
    fr = freqs
    cm = cum
    # Encode in reverse; symbol i belongs to state i & 3.
    for i in range(n - 1, -1, -1):
        s = int(data[i])
        j = i & 3
        x = states[j]
        f = int(fr[s])
        x_max = ((RANS_LOW >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cm[s])
    payload = b"".join(struct.pack("<I", states[j]) for j in range(4))
    payload += bytes(reversed(out_rev))
    body = table + payload
    return struct.pack("<BII", 0, len(body), n) + body


# -- order-1 encode ---------------------------------------------------------

def rans_encode_order1(raw: bytes) -> bytes:
    """Order-1 rANS 4x8 (htslib wire format): 4 interleaved states, each
    encoding a contiguous quarter with the previous byte as context
    (context 0 at each quarter start). Exact inverse of ``_decode1`` —
    the decode loop pops renorm bytes round-robin per position, so the
    encoder walks that schedule in reverse.

    Reference behavior: htsjdk/htslib rANS order-1 (SURVEY.md §2.8 CRAM
    row)."""
    try:
        from disq_tpu_torch.native import rans_encode1_native

        return rans_encode1_native(raw)
    except ImportError:
        pass
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return struct.pack("<BII", 1, 0, 0)
    q = n // 4
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, n]

    # per-context symbol counts (context = previous byte in the quarter,
    # 0 at quarter start)
    counts = np.zeros((256, 256), dtype=np.int64)
    for j in range(4):
        s, e = starts[j], ends[j]
        if e > s:
            seg = data[s:e]
            prev = np.concatenate([[np.uint8(0)], seg[:-1]])
            np.add.at(counts, (prev, seg), 1)
    present = np.flatnonzero(counts.sum(axis=1) > 0)
    freqs = np.zeros((256, 256), dtype=np.int64)
    for c in present:
        freqs[c] = _normalize_freqs(counts[c])
    cum = np.zeros((256, 257), dtype=np.int64)
    np.cumsum(freqs, axis=1, out=cum[:, 1:])

    # context table header mirroring _decode1's RLE-over-contexts parse
    table = bytearray()
    i = 0
    plist = [int(c) for c in present]
    while i < len(plist):
        run = 1
        while (i + run < len(plist)
               and plist[i + run] == plist[i] + run):
            run += 1
        table.append(plist[i])
        table += _write_freq_table0(freqs[plist[i]])
        if run > 1:
            # parser: nxt == last+1 -> read rle count, then auto-advance
            table.append(plist[i] + 1)
            table.append(run - 2)
            for k in range(1, run):
                table += _write_freq_table0(freqs[plist[i] + k])
        i += run
    table.append(0)  # terminator

    # encode: reverse of the decode schedule. Decode pops (k, j) in
    # order k=0..: j=0..3 (j active while k < len_j); we push reversed.
    lens = [ends[j] - starts[j] for j in range(4)]
    kmax = max(lens)
    states = [RANS_LOW] * 4
    out_rev = bytearray()
    for k in range(kmax - 1, -1, -1):
        for j in (3, 2, 1, 0):
            if k >= lens[j]:
                continue
            p = starts[j] + k
            s = int(data[p])
            c = 0 if k == 0 else int(data[p - 1])
            x = states[j]
            f = int(freqs[c][s])
            x_max = ((RANS_LOW >> TF_SHIFT) << 8) * f
            while x >= x_max:
                out_rev.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cum[c][s])
    payload = b"".join(struct.pack("<I", states[j]) for j in range(4))
    payload += bytes(reversed(out_rev))
    body = bytes(table) + payload
    return struct.pack("<BII", 1, len(body), n) + body


# -- decode (order 0 and 1) -------------------------------------------------

def rans0_decode_streams(streams: Sequence[bytes], device,
                         bad: Optional[Dict[int, BaseException]] = None
                         ) -> List[Optional[bytes]]:
    """Decode order-0 streams (full streams incl. the 9-byte header) on
    ``device`` in one launch: kernel B3, or B5 when
    ``DISQ_TPU_TORCH_DEVICE_RANS=legacy``. A stream that does not parse
    or that the kernel flags raises ``ValueError`` naming it; given a
    dict ``bad``, every such stream is recorded there instead and the
    others decode (``ops/rans_simd.decode_streams``). Through the device
    service a flagged stream is decoded again by ``rans_decode`` and
    counts as bad only if that fails too."""
    from disq_tpu_torch.runtime import device_service

    legacy = os.environ.get("DISQ_TPU_TORCH_DEVICE_RANS",
                            "").lower() == "legacy"
    if device_service.enabled() and not legacy:
        return _decode_through_service(streams, device, bad)
    if legacy:
        from disq_tpu_torch.ops.rans import rans0_decode_device

        return rans0_decode_device(streams, device, bad)
    from disq_tpu_torch.ops.rans_simd import rans0_decode_simd

    return rans0_decode_simd(streams, device, bad)


def _decode_through_service(streams, device, bad):
    from disq_tpu_torch.ops.rans_simd import stream_error
    from disq_tpu_torch.runtime import device_service

    if not streams:
        return []
    parts, errors = device_service.get_service(device).submit_rans(
        streams).outcome()
    if errors:
        if bad is None:
            k = min(errors)
            raise stream_error(errors[k], k)
        for k, e in errors.items():
            bad[k] = stream_error(e, k)
            parts[k] = None
    return parts


def rans_decode(data: bytes) -> bytes:
    """Decode one rANS 4x8 stream (full stream incl. the 9-byte header)
    on the host."""
    order, comp_size, raw_size = struct.unpack_from("<BII", data, 0)
    if raw_size == 0:
        return b""
    if order not in (0, 1):
        raise ValueError(f"unknown rANS order {order}")
    counters.book_rans_streams(order, "host")
    if order == 1:
        with span("cram.rans1", bytes=raw_size):
            return _decode_host(data, order, comp_size, raw_size)
    return _decode_host(data, order, comp_size, raw_size)


def _decode_host(data: bytes, order: int, comp_size: int,
                 raw_size: int) -> bytes:
    try:
        from disq_tpu_torch.native import rans_decode_native

        return rans_decode_native(data)
    except ImportError:
        pass
    body = memoryview(data)[9:9 + comp_size]
    if order == 0:
        return _decode0(body, raw_size)
    return _decode1(body, raw_size)


def _decode0(body, raw_size: int) -> bytes:
    freqs, off = _read_freq_table0(body, 0)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    # symbol lookup over the 4096 slots
    lookup = np.repeat(np.arange(256, dtype=np.uint8), freqs)
    if len(lookup) != TOTFREQ:
        raise ValueError("rANS frequency table does not sum to 4096")
    states = list(struct.unpack_from("<4I", body, off))
    off += 16
    out = np.empty(raw_size, dtype=np.uint8)
    fr = freqs
    cm = cum
    ln = len(body)
    for i in range(raw_size):
        j = i & 3
        x = states[j]
        m = x & (TOTFREQ - 1)
        s = int(lookup[m])
        out[i] = s
        x = int(fr[s]) * (x >> TF_SHIFT) + m - int(cm[s])
        while x < RANS_LOW and off < ln:
            x = (x << 8) | body[off]
            off += 1
        states[j] = x
    return out.tobytes()


def _decode1(body, raw_size: int) -> bytes:
    """Order-1: 256 context tables (tables for contexts actually present,
    RLE over contexts like the order-0 symbol list)."""
    freqs = np.zeros((256, 256), dtype=np.int64)
    off = 0
    rle_i = 0
    i = body[off]
    off += 1
    last_i = -2
    while True:
        f, off = _read_freq_table0(body, off)
        freqs[i] = f
        if rle_i > 0:
            rle_i -= 1
            last_i = i
            i += 1
            continue
        last_i = i
        nxt = body[off]
        off += 1
        if nxt == 0:
            break
        if nxt == last_i + 1:
            rle_i = body[off]
            off += 1
        i = nxt
    cum = np.zeros((256, 257), dtype=np.int64)
    np.cumsum(freqs, axis=1, out=cum[:, 1:])
    lookups = {}
    states = list(struct.unpack_from("<4I", body, off))
    off += 16
    out = np.empty(raw_size, dtype=np.uint8)
    # 4 interleaved streams, each decoding a contiguous quarter.
    q = raw_size // 4
    ptrs = [0, q, 2 * q, 3 * q]
    ctx = [0, 0, 0, 0]
    ends = [q, 2 * q, 3 * q, raw_size]
    ln = len(body)
    remaining = raw_size
    # htslib decodes i4[] positions round-robin until each hits its end
    pos = ptrs[:]
    done = [False] * 4
    while remaining:
        for j in range(4):
            if pos[j] >= ends[j]:
                done[j] = True
                continue
            c = ctx[j]
            if c not in lookups:
                lk = np.repeat(np.arange(256, dtype=np.uint8), freqs[c])
                if len(lk) != TOTFREQ:
                    raise ValueError("rANS o1 table does not sum to 4096")
                lookups[c] = lk
            x = states[j]
            m = x & (TOTFREQ - 1)
            s = int(lookups[c][m])
            out[pos[j]] = s
            x = int(freqs[c][s]) * (x >> TF_SHIFT) + m - int(cum[c][s])
            while x < RANS_LOW and off < ln:
                x = (x << 8) | body[off]
                off += 1
            states[j] = x
            ctx[j] = s
            pos[j] += 1
            remaining -= 1
    return out.tobytes()
