"""Raw-DEFLATE inflate under the reference's older rules (kernel B4).

The legacy route of the BAM read (``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy``),
the function of the reference's ``_inflate_kernel``
(``disq_tpu/ops/inflate.py``): a batch of raw-DEFLATE payloads gives a
``(B, 65536)`` byte slab, one row per payload, and ``(B, 2)`` int32
``[len, status]``. Status codes:

  0 ok · 1 bad BTYPE · 2 stored LEN/NLEN mismatch · 3 bad Huffman code ·
  4 invalid distance · 5 output overflow · 6 ran past the compressed
  payload · 7 code-length repeat overflow · 8 ISIZE mismatch

The decoder rules are the reference kernel's, not B1's
(``ops/inflate_simd.py``), and the two differ on corrupt input:

- bytes past a payload read as zero, and a stream has overrun (6) as soon
  as its bit cursor passes ``csize * 8`` — with no slack, checked after
  every Huffman bit, after each literal or match, and after each DEFLATE
  block (stored LEN/NLEN and the dynamic header's fields are read
  unchecked);
- every alphabet decodes bit by bit up to 15 bits (a miss is 3), with no
  completeness check on the code set;
- a distance symbol over 29 or a distance past the output written so far
  is 4; there is no 32 KiB window check;
- a row holds 65,536 bytes: a literal, match or stored block past it
  is 5;
- a stored block whose bytes pass the payload's end is 6 and copies
  nothing;
- a dynamic block whose code lengths fail still decodes its data with
  the tables built so far (the reference's control flow), so ``len``
  counts those bytes;
- ``usize >= 0`` checks the output length (8); ``-1`` skips the check;
- an empty payload reads a non-final stored block of LEN 0, NLEN 0: 2.

On a CUDA tensor ``inflate_stacked`` launches the kernel
(``csrc/inflate_legacy.cu``: one warp per payload, table-driven Huffman
decode, B1's design under these rules); on a CPU tensor it runs
``inflate_stacked_plain``, the same decoder in Python. The reference
pads every batch to a power of two with dummy streams (a compile-cache
workaround of its compiler); the port launches one warp for each of
exactly ``B`` payloads.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from disq_tpu_torch.runtime import counters

CMAX = 66560          # the reference's compressed slot; payloads ≤ CMAX - 8
UMAX = 65536          # output row: the BGZF uncompressed bound
NLIT = 288            # literal/length alphabet
NDIST = 32            # distance alphabet (30 used)
NCL = 19              # code-length alphabet
NLENS = NLIT + NDIST

# RFC 1951 §3.2.5: length codes 257..285.
LBASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258], dtype=np.int32)
LEXT = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0], dtype=np.int32)
# Distance codes 0..29 (padded to 32).
DBASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
     24577, 0, 0], dtype=np.int32)
DEXT = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13, 0, 0], dtype=np.int32)
# RFC 1951 §3.2.7: order of the code-length code lengths.
CLORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)
# RFC 1951 §3.2.6: fixed-Huffman code lengths, literal/length then distance.
FIXED_LENS = np.concatenate(
    [np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8),
     np.full(NDIST, 5)]
).astype(np.int32)

OK, BAD_BTYPE, BAD_STORED, BAD_CODE, BAD_DIST = 0, 1, 2, 3, 4
OUT_OVERFLOW, IN_OVERRUN, REPEAT_OVERFLOW, ISIZE_MISMATCH = 5, 6, 7, 8

_LB, _LX, _DB, _DX = (t.tolist() for t in (LBASE, LEXT, DBASE, DEXT))
_CLO = CLORDER.tolist()


# -- the plain version ------------------------------------------------------


def _table(lens: Sequence[int]):
    """Canonical code of one alphabet as the reference kernel builds it:
    (per-length counts, first codes, offsets, symbols sorted by
    (length, symbol)), no completeness check."""
    cnt = [0] * 16
    for ln in lens:
        if ln > 0:
            cnt[ln] += 1
    first, off = [0] * 16, [0] * 16
    code = acc = 0
    for ln in range(1, 16):
        code = (code + cnt[ln - 1]) * 2
        acc += cnt[ln - 1]
        first[ln], off[ln] = code, acc
    syms = [s for ln in range(1, 16) for s, v in enumerate(lens) if v == ln]
    return cnt, first, off, syms


_FIXED_LIT = _table(FIXED_LENS[:NLIT].tolist())
_FIXED_DIST = _table(FIXED_LENS[NLIT:].tolist())


class _Stream:
    """One payload's decode state: bytes past the payload read as zero."""

    __slots__ = ("buf", "limit", "out")

    def __init__(self, payload: bytes) -> None:
        self.buf = payload
        self.limit = len(payload) * 8
        self.out = bytearray()

    def bits(self, bp: int, n: int) -> int:
        """``n`` ≤ 16 bits at ``bp``, least significant first."""
        i = bp >> 3
        return (int.from_bytes(self.buf[i: i + 3], "little")
                >> (bp & 7)) & ((1 << n) - 1)

    def symbol(self, table, bp: int) -> Tuple[int, int, int]:
        """The kernel's bit-by-bit canonical walk: (symbol, cursor,
        status). Status 6 at the first bit past the payload (with the
        symbol when that bit completes one, else 0), 3 after 15 bits
        without a match (symbol 0)."""
        cnt, first, off, syms = table
        over = max(1, self.limit - bp + 1)  # first length past the limit
        v = self.bits(bp, 15)
        code = 0
        for ln in range(1, 16):
            code = (code << 1) | ((v >> (ln - 1)) & 1)
            idx = code - first[ln]
            hit = 0 <= idx < cnt[ln]
            if ln >= over:
                return (syms[off[ln] + idx] if hit else 0), bp + ln, IN_OVERRUN
            if hit:
                return syms[off[ln] + idx], bp + ln, OK
        return 0, bp + 15, BAD_CODE

    def data(self, bp: int, lit, dist) -> Tuple[int, int]:
        """Literal/match loop up to end-of-block: (cursor, status)."""
        out = self.out
        while True:
            sym, bp, err = self.symbol(lit, bp)
            if err == OK and sym < 256:
                if len(out) < UMAX:
                    out.append(sym)
                else:
                    err = OUT_OVERFLOW
            elif err == OK and sym > 256:
                li = sym - 257
                if li > 28:
                    err, li = BAD_CODE, 28
                length = _LB[li] + self.bits(bp, _LX[li])
                bp += _LX[li]
                dsym, bp, derr = self.symbol(dist, bp)
                if err == OK and derr:
                    err = derr
                if err == OK and dsym > 29:
                    err = BAD_DIST
                dsym = min(dsym, 29)
                d = _DB[dsym] + self.bits(bp, _DX[dsym])
                bp += _DX[dsym]
                op = len(out)
                if err == OK and d > op:
                    err = BAD_DIST
                if err == OK and op + length > UMAX:
                    err = OUT_OVERFLOW
                if err == OK:
                    chunk = out[op - d: op - d + length]
                    if d < length:
                        chunk = (chunk * (length // d + 1))[:length]
                    out += chunk
            if err == OK and bp > self.limit:
                err = IN_OVERRUN
            if sym == 256 or err:
                return bp, err

    def stored(self, bp: int) -> Tuple[int, int]:
        bp = (bp + 7) & ~7
        blen = self.bits(bp, 16)
        nlen = self.bits(bp + 16, 16)
        bp += 32
        if blen ^ 0xFFFF != nlen:
            return bp, BAD_STORED
        if len(self.out) + blen > UMAX:
            return bp, OUT_OVERFLOW
        if bp + blen * 8 > self.limit:
            return bp, IN_OVERRUN
        src = bp >> 3
        self.out += self.buf[src: src + blen]
        return bp + blen * 8, OK

    def dynamic(self, bp: int) -> Tuple[int, int]:
        hlit = self.bits(bp, 5) + 257
        hdist = self.bits(bp + 5, 5) + 1
        hclen = self.bits(bp + 10, 4) + 4
        bp += 14
        lens = [0] * NLENS
        for i in range(hclen):
            lens[_CLO[i]] = self.bits(bp, 3)
            bp += 3
        cl = _table(lens[:NCL])
        lens[:NCL] = [0] * NCL
        total = hlit + hdist
        n = err = 0
        while n < total and err == OK:
            sym, bp, err = self.symbol(cl, bp)
            rep = 1
            if sym >= 16:
                nb, base = {16: (2, 3), 17: (3, 3), 18: (7, 11)}[sym]
                rep = base + self.bits(bp, nb)
                bp += nb
            prev = lens[max(n - 1, 0)]
            if sym == 16 and n == 0:
                err = REPEAT_OVERFLOW
            val = sym if sym < 16 else (prev if sym == 16 else 0)
            count = 1 if sym < 16 else rep
            if err == OK and n + count > total:
                err = REPEAT_OVERFLOW
            if err == OK:
                lens[n: n + count] = [val] * count
                n += count
        # the distance lengths move to their fixed base; the data loop
        # runs even after a failed length decode, as in the reference
        dist_lens = [lens[min(hlit + i, NLENS - 1)] if i < hdist else 0
                     for i in range(NDIST)]
        lit_lens = lens[:hlit] + [0] * (NLIT - hlit)
        bp, derr = self.data(bp, _table(lit_lens), _table(dist_lens))
        return bp, err if err else derr

    def run(self, usize: int) -> int:
        bp, err, final = 0, OK, 0
        while not final and err == OK:
            hdr = self.bits(bp, 3)
            bp += 3
            final, btype = hdr & 1, hdr >> 1
            if btype == 0:
                bp, err = self.stored(bp)
            elif btype == 1:
                bp, err = self.data(bp, _FIXED_LIT, _FIXED_DIST)
            elif btype == 2:
                bp, err = self.dynamic(bp)
            else:
                err = BAD_BTYPE
            if err == OK and bp > self.limit:
                err = IN_OVERRUN
        if err == OK and usize >= 0 and len(self.out) != usize:
            err = ISIZE_MISMATCH
        return err


def inflate_one(payload: bytes, usize: int = -1) -> Tuple[bytes, int]:
    """One payload through the plain decoder: (row bytes, status)."""
    s = _Stream(bytes(payload))
    err = s.run(int(usize))
    return bytes(s.out), err


def inflate_stacked_plain(comp: torch.Tensor, pay_off: torch.Tensor,
                          csizes: torch.Tensor, usizes: torch.Tensor):
    """The plain version of the kernel: every payload through
    ``inflate_one`` on the host; results on the inputs' device."""
    data = comp.cpu().numpy().tobytes()
    po, cs, us = (t.cpu().numpy() for t in (pay_off, csizes, usizes))
    n = len(po)
    out = np.zeros((n, UMAX), dtype=np.uint8)
    meta = np.zeros((n, 2), dtype=np.int32)
    for i in range(n):
        row, meta[i, 1] = inflate_one(data[po[i]: po[i] + cs[i]], us[i])
        out[i, :len(row)] = np.frombuffer(row, dtype=np.uint8)
        meta[i, 0] = len(row)
    dev = comp.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(meta).to(dev)


# -- the kernel wrapper -----------------------------------------------------


def _lib():
    from disq_tpu_torch.ops import cuda_build

    lib = cuda_build.load("inflate_legacy")
    if lib.disq_inflate_legacy_launch.argtypes is None:
        lib.disq_inflate_legacy_launch.restype = ctypes.c_int
        lib.disq_inflate_legacy_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_void_p]
    return lib


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous() \
            or t.dim() != 1:
        raise ValueError(
            f"{name}: want a contiguous 1-D {dtype} tensor on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def inflate_stacked(comp: torch.Tensor, pay_off: torch.Tensor,
                    csizes: torch.Tensor, usizes: torch.Tensor):
    """Decode ``B`` payloads ``comp[pay_off[i] : pay_off[i] + csizes[i]]``:
    returns ``(out uint8 (B, 65536), meta int32 (B, 2))`` with
    ``meta[i] = [len, status]``; ``usizes[i] = -1`` skips the ISIZE
    check. A payload over ``CMAX - 8`` bytes raises ``ValueError``
    before any launch."""
    dev = comp.device
    _check("comp", comp, torch.uint8, dev)
    _check("pay_off", pay_off, torch.int64, dev)
    _check("csizes", csizes, torch.int32, dev)
    _check("usizes", usizes, torch.int32, dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"inflate_stacked runs on cuda or cpu, not {dev}")
    n = pay_off.numel()
    if csizes.numel() != n or usizes.numel() != n:
        raise ValueError("pay_off, csizes and usizes disagree on the batch")
    if n and int(csizes.max()) > CMAX - 8:
        i = int(torch.argmax(csizes))
        raise ValueError(
            f"payload {i} exceeds BGZF bound: {int(csizes[i])}")
    if dev.type == "cpu":
        return inflate_stacked_plain(comp, pay_off, csizes, usizes)
    out = torch.empty((n, UMAX), dtype=torch.uint8, device=dev)
    meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.disq_inflate_legacy_launch(
                comp.data_ptr(), pay_off.data_ptr(), csizes.data_ptr(),
                usizes.data_ptr(), out.data_ptr(), meta.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream)
        from disq_tpu_torch.ops.cuda_build import check_launch

        check_launch("inflate_legacy", rc)
        counters.book_launch("inflate_legacy")
    return out, meta


# -- host side ----------------------------------------------------------------


def stage_payloads(data, pay_off, pay_len, usizes: Optional[Sequence[int]],
                   device):
    """Kernel inputs for payloads at ``pay_off``/``pay_len`` of ``data``
    (the staged compressed bytes, uploaded once)."""
    from disq_tpu_torch.runtime.device_pipeline import upload

    device = torch.device(device)
    n = len(pay_off)
    us = (np.full(n, -1, dtype=np.int32) if usizes is None
          else np.asarray(usizes, dtype=np.int32))
    return tuple(
        upload(np.asarray(a, dtype=dt), device)
        for a, dt in ((np.frombuffer(data, dtype=np.uint8)
                       if not isinstance(data, np.ndarray) else data, np.uint8),
                      (pay_off, np.int64), (pay_len, np.int32), (us, np.int32)))


def inflate_rows(data, pay_off, pay_len, usizes: Optional[Sequence[int]],
                 device) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel on the payloads at ``pay_off``/``pay_len`` of ``data``:
    host ``(rows, meta)``, the copy back from the card booked. The
    caller checks ``meta`` with ``check_meta``."""
    from disq_tpu_torch.runtime.tracing import device_span

    with device_span("device.kernel", kernel="inflate", blocks=len(pay_off)):
        out, meta = inflate_stacked(*stage_payloads(data, pay_off, pay_len,
                                                    usizes, device))
        meta = meta.cpu().numpy()
    rows = out.cpu().numpy()
    if out.is_cuda:
        counters.book_transfer("d2h", rows.nbytes + meta.nbytes)
    return rows, meta


def check_meta(meta: np.ndarray) -> None:
    """Raise the reference's error for the first flagged payload, as a
    ``FlaggedBlocksError`` listing every flagged one."""
    from disq_tpu_torch.runtime.errors import FlaggedBlocksError

    bad = np.nonzero(meta[:, 1])[0]
    if len(bad):
        i = int(bad[0])
        raise FlaggedBlocksError(
            f"device inflate failed for block {i}: error {int(meta[i, 1])}",
            bad)


def inflate_payloads(payloads: Sequence[bytes],
                     usizes: Optional[Sequence[int]] = None,
                     device=None) -> List[bytes]:
    """Raw-DEFLATE payloads → decoded bytes through the kernel (its
    plain version on the CPU); any nonzero status raises
    ``ValueError("device inflate failed for block {i}: error {code}")``.
    ``usizes`` enables the ISIZE check per payload."""
    from disq_tpu_torch.util import resolve_device

    device = resolve_device(device)
    if not payloads:
        return []
    for i, p in enumerate(payloads):
        if len(p) > CMAX - 8:
            raise ValueError(f"payload {i} exceeds BGZF bound: {len(p)}")
    lens = np.array([len(p) for p in payloads], dtype=np.int64)
    off = np.zeros(len(payloads), dtype=np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    blob = np.frombuffer(b"".join(bytes(p) for p in payloads), dtype=np.uint8)
    rows, meta = inflate_rows(blob, off, lens, usizes, device)
    check_meta(meta)
    return [rows[i, :meta[i, 0]].tobytes() for i in range(len(payloads))]
