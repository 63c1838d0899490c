"""Device-resident parse of a decoded shard.

``parse_columns_resident`` turns a decoded blob on the device plus the
host scan's record offsets into the fixed columns, in one launch of the
parse kernel (``ops/parse.py``), which reads the record prefixes in
place. The inflate kernel already wrote each block at its final offset
in one blob, so there is no assembly or padding step; offsets are int64
throughout, so a decoded shard of 2 GiB or more needs no special case.

With a mesh (``runtime/mesh.py``) the blob goes to every shard's device,
the record starts are split over the ``batch`` axis, and the parse kernel
runs once per shard on its slice of starts: the columns come back as a
batch-sharded set (one tensor per shard).

``run_device_pipeline`` is the reference's parse → sort → flagstat chain
over a decoded shard, with its lazy ``DevicePipelineResult``.

``gather_record_words`` is the prefix gather as torch ops — the part of
the parse kernel's plain version that the kernel fuses away.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import device_span, span

N_WORDS = 9


def gather_record_words(blob: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The 9 little-endian words of each record's 36-byte prefix as
    ``(N, 9)`` int32, assembled from the bytes at ``starts[i] + 0..35``;
    bytes past the blob read as zero."""
    idx = starts[:, None] + torch.arange(4 * N_WORDS, device=blob.device)
    inside = idx < blob.numel()
    b = torch.where(inside, blob[idx.clamp(max=blob.numel() - 1)],
                    torch.zeros((), dtype=blob.dtype, device=blob.device))
    b = b.to(torch.int64).view(-1, N_WORDS, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    # the u32 value as int32 (two's complement wrap)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device``, booking h2d bytes and a
    ``device.transfer`` span for a card. A read-only array (a view of
    staged ``bytes``) is wrapped without a copy: the tensor is only ever
    read — copied to the card, or read by a plain version on the CPU."""
    array = np.ascontiguousarray(array)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(array)
    if device.type != "cuda":
        return t.to(device)
    counters.book_transfer("h2d", t.numel() * t.element_size())
    with span("device.transfer", direction="h2d"):
        return t.to(device)


def parse_columns_resident(
    device_blob: torch.Tensor,
    offsets: np.ndarray,
    origin: int = 0,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """The 12 parse fields of the records at ``offsets`` as columns on
    ``device_blob``'s device. ``device_blob`` (the inflate kernel's
    output) is parsed in place, with ``origin`` rebasing the offsets
    into it. With ``mesh`` the blob is placed on every shard's device,
    each shard parses its ``shard_bounds`` slice of the records, and
    every column is a list of per-shard tensors."""
    from disq_tpu_torch.ops.parse import columns, parse_records

    starts_host = np.asarray(offsets[:-1], dtype=np.int64) + origin
    n = len(starts_host)
    if mesh is None:
        starts = upload(starts_host, device_blob.device)
        with device_span("device.kernel", kernel="columnar_parse",
                         records=n) as fence:
            return columns(fence.sync(parse_records(device_blob, starts)))
    from disq_tpu_torch.runtime.mesh import mesh_put, shard_bounds
    from disq_tpu_torch.runtime.tracing import counter

    blobs = mesh_put(device_blob, mesh, batch=False)
    bounds = shard_bounds(n, len(blobs))
    parsed = []
    with device_span("device.kernel", kernel="columnar_parse", records=n,
                     devices=len(blobs)) as fence:
        for blob, (lo, hi) in zip(blobs, bounds):
            starts = upload(starts_host[lo:hi], blob.device)
            parsed.append(columns(parse_records(blob, starts)))
        fence.sync([p["pos"] for p in parsed])
    counter("device.mesh.batches").inc()
    return {k: [p[k] for p in parsed] for k in parsed[0]}


class DevicePipelineResult:
    """Lazy handle over ``run_device_pipeline``'s device outputs.

    Tuple unpacking (``keys, order, stats = run_device_pipeline(...)``)
    fetches all three; attribute access (``res.stats``) fetches only that
    piece, once. ``release()`` books the results never fetched into
    ``device.d2h_avoided_bytes``."""

    __slots__ = ("_dev", "_np", "_released", "__weakref__")

    def __init__(self, key=None, order=None, fs=None,
                 host: Optional[Dict[str, np.ndarray]] = None) -> None:
        self._dev = (None if host is not None
                     else {"key": key, "order": order, "fs": fs})
        self._np: Dict[str, np.ndarray] = dict(host or {})
        self._released = False

    @classmethod
    def empty(cls) -> "DevicePipelineResult":
        from disq_tpu_torch.ops.flagstat import FLAGSTAT_FIELDS

        return cls(host={
            "key": np.zeros(0, np.uint64), "order": np.zeros(0, np.int64),
            "fs": np.zeros(len(FLAGSTAT_FIELDS), np.int64)})

    def _fetch(self, *names: str) -> None:
        if self._dev is None:
            if any(m not in self._np for m in names):
                raise RuntimeError(
                    "result accessed after release() — fetch before "
                    "releasing the DevicePipelineResult")
            return
        missing = [m for m in names if m not in self._np]
        if not missing:
            return
        with span("device.transfer", direction="d2h"):
            got = {m: self._dev[m].cpu().numpy() for m in missing}
        if self._dev["order"].is_cuda:
            counters.book_transfer("d2h", sum(a.nbytes for a in got.values()))
        if "key" in got:
            got["key"] = got["key"].view(np.uint64)
        self._np.update(got)
        if all(k in self._np for k in ("key", "order", "fs")):
            self._dev = None

    @property
    def keys(self) -> np.ndarray:
        """Sorted u64 coordinate keys."""
        self._fetch("key")
        return self._np["key"]

    @property
    def order(self) -> np.ndarray:
        self._fetch("order")
        return self._np["order"]

    @property
    def stats(self) -> Dict[str, int]:
        from disq_tpu_torch.ops.flagstat import FLAGSTAT_FIELDS

        self._fetch("fs")
        return {k: int(v) for k, v in zip(FLAGSTAT_FIELDS, self._np["fs"])}

    def release(self) -> None:
        """Drop the device results; those never fetched book into
        ``device.d2h_avoided_bytes``."""
        if self._released:
            return
        self._released = True
        if self._dev is not None:
            avoided = sum(t.numel() * t.element_size()
                          for m, t in self._dev.items() if m not in self._np)
            if avoided:
                from disq_tpu_torch.runtime.tracing import counter

                counter("device.d2h_avoided_bytes").inc(avoided)
        self._dev = None

    def __iter__(self) -> Iterator:
        self._fetch("key", "order", "fs")
        yield self.keys
        yield self.order
        yield self.stats


def run_device_pipeline(blob: np.ndarray, offsets: np.ndarray,
                        device=None, mesh=None) -> DevicePipelineResult:
    """Parse a decoded shard on the device (kernel B2), build its sorted
    coordinate keys and permutation and its flagstat there, and hand back
    a lazy result. ``blob`` is the decoded BGZF payload bytes (u8) and
    ``offsets`` the ``(n + 1,)`` record offsets. ``device`` is ``cuda``
    unless given; with ``mesh`` the parse, the flagstat and the sort run
    over its shards (``ColumnarBatch`` with a mesh)."""
    from disq_tpu_torch.runtime.columnar import coordinate_key
    from disq_tpu_torch.ops.flagstat import FLAGSTAT_FIELDS, _counts
    from disq_tpu_torch.util import resolve_device

    if len(offsets) <= 1:
        return DevicePipelineResult.empty()
    offsets = np.asarray(offsets, dtype=np.int64)
    if mesh is not None:
        from disq_tpu_torch.runtime.columnar import ColumnarBatch

        dev = mesh.local_devices[0]
        batch = ColumnarBatch.from_blob(blob, offsets, upload(blob, dev),
                                        mesh=mesh)
        order = batch.sort_permutation()
        stats = batch.flagstat()
        fs = np.asarray([stats[k] for k in FLAGSTAT_FIELDS], dtype=np.int64)
        refid, pos = batch.refid, batch.pos
        batch.release()
        from disq_tpu_torch.sort.coordinate import coordinate_keys

        return DevicePipelineResult(host={
            "key": coordinate_keys(refid, pos)[order], "order": order,
            "fs": fs})
    dev = resolve_device(device)
    cols = parse_columns_resident(upload(blob, dev), offsets)
    with device_span("device.kernel", kernel="device_pipeline",
                     records=len(offsets) - 1) as fence:
        key = coordinate_key(cols["refid"], cols["pos"])
        srt = torch.sort(key, stable=True)
        fs = _counts(cols["flag"])
        fence.sync(fs)
    return DevicePipelineResult(srt.values, srt.indices, fs)

