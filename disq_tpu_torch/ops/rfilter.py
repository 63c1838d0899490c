"""Read filter: flag predicates, a MAPQ floor and a seeded subsample
(the ``samtools view -f/-F/-q/-s`` family), applied inside the decode.

Counterpart of ``disq_tpu/ops/rfilter.py``. A device-backed batch builds
its keep mask on its device from the resident flag and mapq columns
(kernel F1, ``csrc/read_filter.cu``) and compacts with
``ColumnarBatch.filter`` before any record column crosses d2h; a host
batch evaluates the same predicate in numpy (``host_mask``). Both sides
share the integer-exact subsample hash, so the kept set is the same bit
for bit wherever the mask was built.

Grammar (``DisqOptions.read_filter`` / env ``DISQ_TPU_TORCH_READ_FILTER``
/ ``ReadsStorage.read_filter()``), as ``samtools view``::

    -f INT    require all of these flag bits (int or 0x hex)
    -F INT    exclude records with any of these flag bits
    -q INT    minimum MAPQ
    -s SEED.FRAC   keep ~FRAC of records, seeded subsample keyed on a
                   hash of the read name (both mates of a pair share a
                   name, so they are kept or dropped together)

e.g. ``"-F 0x904 -q 30 -s 42.25"``.

``build_mask`` is F1's wrapper: on a CUDA tensor it launches the kernel
(one thread per record) or raises; on a CPU tensor it runs
``mask_plain``, the same predicate as torch ops in int64 with the
32-bit wraparound spelled out after each step.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from disq_tpu_torch.runtime import counters

# splitmix32-style finalizer constants, shared by the numpy mask, the
# plain version and the kernel (u32 wraparound arithmetic on all three)
_SEED_MIX = 0x9E3779B9
_MIX_A = 0x7FEB352D
_MIX_B = 0x846CA68B
_FNV_BASIS = 0x811C9DC5
_FNV_PRIME = 0x01000193
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class ReadFilter:
    """A parsed predicate; immutable so sources can cache it."""

    require_flags: int = 0
    exclude_flags: int = 0
    min_mapq: int = 0
    subsample: Optional[float] = None  # keep fraction in [0, 1)
    seed: int = 0

    @property
    def needs_name_hash(self) -> bool:
        return self.subsample is not None

    @property
    def threshold(self) -> int:
        """u32 keep threshold for the subsample hash comparison."""
        if self.subsample is None:
            return _U32
        return min(_U32, int(round(self.subsample * 2 ** 32)))

    @property
    def seed_mix(self) -> int:
        return (self.seed * _SEED_MIX) & _U32


_TOKEN_RE = re.compile(r"^(0[xX][0-9a-fA-F]+|\d+)$")


def _parse_int(tok: str, opt: str) -> int:
    if not _TOKEN_RE.match(tok):
        raise ValueError(
            f"read_filter: {opt} wants an integer (or 0x hex), got {tok!r}")
    return int(tok, 0)


def parse_read_filter(spec: str) -> ReadFilter:
    """Parse the ``samtools view``-shaped grammar above. Raises
    ``ValueError`` on unknown options or malformed operands, when the
    options are built, never mid-read."""
    toks = spec.split()
    req = exc = minq = 0
    frac: Optional[float] = None
    seed = 0
    i = 0
    while i < len(toks):
        opt = toks[i]
        if i + 1 >= len(toks):
            raise ValueError(f"read_filter: {opt} missing its operand")
        val = toks[i + 1]
        if opt == "-f":
            req = _parse_int(val, opt)
        elif opt == "-F":
            exc = _parse_int(val, opt)
        elif opt == "-q":
            minq = _parse_int(val, opt)
        elif opt == "-s":
            # samtools -s: the integer part is the seed, the fraction the rate
            try:
                f = float(val)
            except ValueError:
                raise ValueError(
                    f"read_filter: -s wants SEED.FRAC, got {val!r}")
            if f < 0:
                raise ValueError(f"read_filter: -s must be >= 0, got {val}")
            seed = int(f)
            frac = f - seed
            if frac >= 1.0 or (frac == 0.0 and "." not in val):
                # "-s 3" keeps everything: always a typo for "-s 3.x"
                raise ValueError(
                    f"read_filter: -s {val!r} has no keep fraction")
        else:
            raise ValueError(
                f"read_filter: unknown option {opt!r} "
                "(grammar: -f/-F/-q INT, -s SEED.FRAC)")
        i += 2
    return ReadFilter(require_flags=req, exclude_flags=exc,
                      min_mapq=minq, subsample=frac, seed=seed)


# -- name hashing (the subsample key) ----------------------------------------


def _fnv_loop(h: np.ndarray, char_at, nlen: np.ndarray) -> np.ndarray:
    """FNV-1a over every record's name at once: ``char_at(i)`` yields
    the i-th name byte per record; one vectorized pass per byte of the
    longest name."""
    maxlen = int(nlen.max()) if len(nlen) else 0
    for i in range(maxlen):
        live = i < nlen
        ch = char_at(i)
        h = np.where(live,
                     (h ^ ch.astype(np.uint32)) * np.uint32(_FNV_PRIME), h)
    return h


def name_hashes_from_blob(blob: np.ndarray, offsets: np.ndarray,
                          order: Optional[np.ndarray] = None) -> np.ndarray:
    """u32 FNV-1a of each record's read name, straight from the record
    bytes (no host record parse). ``order`` maps logical record index
    to blob record index (a ``permuted()`` batch)."""
    off = np.asarray(offsets[:-1], dtype=np.int64)
    if order is not None:
        off = off[np.asarray(order, dtype=np.int64)]
    n = len(off)
    if n == 0:
        return np.zeros(0, np.uint32)
    # l_read_name (u8 at record offset 12) counts the trailing NUL
    nlen = blob[off + 12].astype(np.int64) - 1
    limit = len(blob) - 1
    h = np.full(n, _FNV_BASIS, np.uint32)
    return _fnv_loop(
        h, lambda i: blob[np.minimum(off + 36 + i, limit)], nlen)


def name_hashes_from_columns(names: np.ndarray,
                             name_offsets: np.ndarray) -> np.ndarray:
    """The same hash from a host batch's ragged name column."""
    off = np.asarray(name_offsets[:-1], dtype=np.int64)
    n = len(off)
    if n == 0:
        return np.zeros(0, np.uint32)
    nlen = np.diff(np.asarray(name_offsets, dtype=np.int64))
    limit = max(0, len(names) - 1)
    h = np.full(n, _FNV_BASIS, np.uint32)
    pad = names if len(names) else np.zeros(1, np.uint8)
    return _fnv_loop(
        h, lambda i: pad[np.minimum(off + i, limit)], nlen)


def _subsample_keep_host(h: np.ndarray, seed: int,
                         threshold: int) -> np.ndarray:
    x = h.astype(np.uint32) ^ np.uint32((seed * _SEED_MIX) & _U32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(_MIX_A)
    x ^= x >> np.uint32(15)
    x *= np.uint32(_MIX_B)
    x ^= x >> np.uint32(16)
    return x < np.uint32(threshold)


# -- the keep mask -----------------------------------------------------------


def host_mask(rf: ReadFilter, flag: np.ndarray, mapq: np.ndarray,
              name_hash: Optional[np.ndarray] = None) -> np.ndarray:
    """The predicate on host columns: the host decode's mask."""
    f = flag.astype(np.uint32)
    keep = ((f & np.uint32(rf.require_flags)) == np.uint32(rf.require_flags))
    keep &= (f & np.uint32(rf.exclude_flags)) == 0
    keep &= mapq.astype(np.uint32) >= np.uint32(rf.min_mapq)
    if rf.needs_name_hash:
        if name_hash is None:
            raise ValueError("subsample filter needs name hashes")
        keep &= _subsample_keep_host(name_hash, rf.seed, rf.threshold)
    return keep


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def mask_plain(flag: torch.Tensor, mapq: torch.Tensor,
               name_hash: Optional[torch.Tensor], req: int, exc: int,
               minq: int, seed_mix: int, thresh: int) -> torch.Tensor:
    """F1's plain version: the predicate and the subsample mix as torch
    ops in int64, masked to 32 bits after each step. ``name_hash`` holds
    the u32 hashes as int32 bits (None: all 0). Returns a uint8 keep
    mask."""
    f = flag.to(torch.int64) & _U32
    keep = (f & req) == req
    keep &= (f & exc) == 0
    keep &= (mapq.to(torch.int64) & _U32) >= minq
    x = (torch.zeros_like(f) if name_hash is None
         else name_hash.to(torch.int64) & _U32) ^ seed_mix
    x ^= x >> 16
    x = _mul_u32(x, _MIX_A)
    x ^= x >> 15
    x = _mul_u32(x, _MIX_B)
    x ^= x >> 16
    keep &= x < thresh
    return keep.to(torch.uint8)


def _lib():
    from disq_tpu_torch.ops import cuda_build

    lib = cuda_build.load("read_filter")
    if lib.disq_read_filter_launch.argtypes is None:
        lib.disq_read_filter_launch.restype = ctypes.c_int
        lib.disq_read_filter_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p]
    return lib


def build_mask(flag: torch.Tensor, mapq: torch.Tensor,
               name_hash: Optional[torch.Tensor], req: int, exc: int,
               minq: int, seed_mix: int, thresh: int) -> torch.Tensor:
    """The uint8 keep mask of ``n`` records from their int32 ``flag``
    and ``mapq`` columns and (for ``-s``) their u32 name hashes as
    int32 ``name_hash``, all on one device: kernel F1 on ``cuda``, the
    plain version on the CPU. The scalars are the filter's u32
    operands (``ReadFilter`` fields, ``seed_mix``, ``threshold``)."""
    dev = flag.device
    n = flag.numel()
    cols = [("flag", flag), ("mapq", mapq)]
    if name_hash is not None:
        cols.append(("name_hash", name_hash))
    for name, t in cols:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != dev or t.numel() != n:
            raise ValueError(f"{name}: want a contiguous 1-D int32 tensor of "
                             f"{n} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    scalars = [int(v) & _U32 for v in (req, exc, minq, seed_mix, thresh)]
    if dev.type == "cpu":
        return mask_plain(flag, mapq, name_hash, *scalars)
    if dev.type != "cuda":
        raise ValueError(f"read_filter runs on cuda or cpu, not {dev}")
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.disq_read_filter_launch(
                flag.data_ptr(), mapq.data_ptr(),
                None if name_hash is None else name_hash.data_ptr(), n,
                *scalars, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        from disq_tpu_torch.ops.cuda_build import check_launch

        check_launch("read_filter", rc)
        counters.book_launch("read_filter")
    return out


def resident_mask(rf: ReadFilter, batch) -> np.ndarray:
    """The keep mask of a device-backed ``ColumnarBatch``, built on its
    device from the resident flag and mapq columns; one byte per record
    crosses d2h (the blob compaction needs the mask on the host). The
    subsample's name hashes come from the record blob on the host (names
    are ragged) and go up once, 4 bytes per record."""
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.runtime.tracing import device_span

    if not getattr(batch, "device_backed", False):
        raise ValueError("resident_mask needs a device-backed batch")
    dev = batch.device_columns()
    n = batch.count
    nh = None
    if rf.needs_name_hash:
        src = batch.encode_source()
        if src is None:
            raise ValueError(
                "subsample filter needs the record blob for name hashes")
        nh = upload(name_hashes_from_blob(*src).view(np.int32),
                    batch.device)
    with device_span("device.kernel", kernel="read_filter",
                     records=n) as fence:
        keep = fence.sync(build_mask(
            dev["flag"], dev["mapq"], nh, rf.require_flags,
            rf.exclude_flags, rf.min_mapq, rf.seed_mix, rf.threshold))
    out = keep.cpu().numpy().astype(bool)
    if keep.is_cuda:
        counters.book_transfer("d2h", n)
    return out


def apply_read_filter(batch, rf: ReadFilter):
    """Filter any batch flavor: a device-backed ``ColumnarBatch`` builds
    its mask on its device and compacts there; a host batch evaluates
    the same predicate in numpy. Books ``ops.filter.records_in`` /
    ``_kept`` under an ``ops.filter.apply`` span."""
    from disq_tpu_torch.runtime.tracing import counter, span

    n = int(batch.count)
    with span("ops.filter.apply", records=n):
        if getattr(batch, "device_backed", False):
            mask = resident_mask(rf, batch)
        else:
            nh = None
            if rf.needs_name_hash:
                nh = name_hashes_from_columns(batch.names,
                                              batch.name_offsets)
            mask = host_mask(rf, np.asarray(batch.flag),
                             np.asarray(batch.mapq), nh)
        out = batch.filter(mask)
        counter("ops.filter.records_in").inc(n)
        counter("ops.filter.records_kept").inc(int(out.count))
    return out
