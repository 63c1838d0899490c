"""Coordinate sort over a device mesh: a range partition, an all-to-all
exchange and a local sort on every shard.

Counterpart of ``disq_tpu/sort/sharded.py``. The reference runs each
stage as a ``shard_map`` body over a ``jax.sharding.Mesh``; here the
bodies are torch ops on one shard's tensors and the collectives are
``runtime/mesh.psum`` / ``all_to_all`` (``runtime/mesh.py``). The
protocol is the reference's:

1. each shard holds its keys as (hi, lo) 32-bit halves of the u64
   coordinate key plus global row ids, sentinel-padded
   (``0xFFFFFFFF`` pairs);
2. splitters (shards − 1 quantiles: sampled on the host by
   ``sample_splitters``, or exact by the ``psum``-histogram search of
   ``_psum_splitters``) give every key its destination shard;
3. each shard groups its keys by destination into a fixed-capacity
   ``(n_shards, cap)`` send buffer, a ``psum`` of the over-capacity
   counts says whether every bucket fit, ``all_to_all`` exchanges the
   buffers, and each shard sorts what it received by (hi, lo, row);
4. a bucket that did not fit re-runs the step with twice the capacity;
   after ``max_retries`` the host argsort finishes the job.

Rows are the least significant sort component, so duplicate keys keep
their input order at any shard count and on both exchange shapes (flat,
and the two-level ``dcn`` × ``shards`` one): the permutation equals
``np.argsort(keys, kind="stable")``.

The halves are int64 tensors holding u32 values; a (hi, lo) pair maps to
the int64 ``(hi − 2**31) · 2**32 + lo``, monotone in the u64 key.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from disq_tpu_torch.runtime.mesh import (
    Mesh,
    all_to_all,
    local_devices,
    psum,
)

SENT32 = 0xFFFFFFFF


def make_mesh(n_devices: Optional[int] = None, axis: str = "shards",
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local devices (all by
    default) of ``device``'s type (``cuda`` unless given)."""
    from disq_tpu_torch.util import resolve_device

    devs = local_devices(resolve_device(device))
    n = n_devices or len(devs)
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr, (axis,))


def split_u64_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host u64 coordinate keys → (hi, lo) u32 halves."""
    return (
        (keys >> np.uint64(32)).astype(np.uint32),
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def sample_splitters(keys: np.ndarray, n_shards: int,
                     oversample: int = 64) -> np.ndarray:
    """Host-side quantile splitters (``(n_shards − 1,)`` u64) for the
    range partition, from a seeded sample: the same values as the
    reference's."""
    if n_shards <= 1 or len(keys) == 0:
        return np.zeros(max(n_shards - 1, 0), dtype=np.uint64)
    rng = np.random.default_rng(0)
    m = min(len(keys), n_shards * oversample)
    sample = np.sort(rng.choice(keys, size=m, replace=False))
    qs = (np.arange(1, n_shards) * m) // n_shards
    return sample[qs].astype(np.uint64)


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The (hi, lo) u32 pair as one int64, in u64 key order."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def _dest_shard(hi, lo, s_hi, s_lo) -> torch.Tensor:
    """Range-partition destination: the number of splitters less than or
    equal to each key (``side='right'``)."""
    if s_hi.numel() == 0:
        return torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    key = _key64(hi, lo)
    s_key = _key64(s_hi, s_lo)
    return (s_key[:, None] <= key[None, :]).sum(0)


def _group_scatter(bucket, nb, cap, arrs, fills):
    """Group-by-destination scatter shared by every exchange stage:
    stable-sort by bucket, rank within each group, and scatter each array
    into a fixed-capacity ``(nb, cap)`` send buffer (the phantom bucket
    ``nb`` and over-capacity entries are dropped); returns the buffers
    and the per-bucket counts for the overflow check."""
    order = torch.sort(bucket, stable=True).indices
    b_g = bucket[order]
    group_start = torch.searchsorted(b_g, b_g, side="left")
    within = torch.arange(b_g.numel(), device=b_g.device) - group_start
    keep = (b_g < nb) & (within < cap)
    rows, cols = b_g[keep], within[keep]
    outs = []
    for a, fill in zip(arrs, fills):
        buf = torch.full((nb, cap) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        buf[rows, cols] = a[order][keep]
        outs.append(buf)
    counts = torch.bincount(b_g[b_g < nb], minlength=nb)
    return outs, counts


def _valid(hi, lo) -> torch.Tensor:
    return ~((hi == SENT32) & (lo == SENT32))


def _local_sort(fh, fl, fr, fv=None):
    """One shard's received keys in (hi, lo, row) order, and its count of
    real (non-sentinel) keys."""
    o1 = torch.sort(fr, stable=True).indices
    o2 = torch.sort(_key64(fh[o1], fl[o1]), stable=True).indices
    final = o1[o2]
    out = [fh[final], fl[final], fr[final]]
    if fv is not None:
        out.append(fv[final])
    out.append(_valid(out[0], out[1]).sum())
    return out


def _capacity(per_shard: int, capacity_factor: float, n: int) -> int:
    return max(1, min(int(per_shard * capacity_factor / n) + 1, per_shard))


def _exchange(shard_arrs, buckets, nb, cap, fills, mesh, axis):
    """One bucket scatter + ``all_to_all`` over ``axis``: every shard's
    arrays (``shard_arrs[i]``) grouped by ``buckets[i]``; returns each
    shard's received arrays (flattened) and its over-capacity count."""
    sends, over = [], []
    for arrs, b in zip(shard_arrs, buckets):
        bufs, counts = _group_scatter(b, nb, cap, arrs, fills)
        sends.append(bufs)
        over.append((counts > cap).sum().reshape(1))
    recv = [all_to_all([s[k] for s in sends], mesh, axis)
            for k in range(len(fills))]
    out = [[recv[k][i].reshape((-1,) + tuple(recv[k][i].shape[2:]))
            for k in range(len(fills))] for i in range(len(shard_arrs))]
    return out, over


def _sort_stage(hi, lo, rows, s_hi, s_lo, *, mesh: Mesh, axis: str,
                n_shards: int, cap: int, vals=None):
    """The flat exchange's body over every shard: bucket by the
    splitters, check the capacity with a ``psum``, ``all_to_all`` the
    buckets, and sort what each shard received. ``vals`` (per shard
    ``(m, W)``) rides along."""
    fills = (SENT32, SENT32, 0) + ((0,) if vals is not None else ())
    shard_arrs, buckets = [], []
    for i in range(len(hi)):
        arrs = [hi[i], lo[i], rows[i]] + ([vals[i]] if vals is not None
                                          else [])
        dest = _dest_shard(hi[i], lo[i], s_hi[i], s_lo[i])
        buckets.append(torch.where(_valid(hi[i], lo[i]), dest,
                                   torch.full_like(dest, n_shards)))
        shard_arrs.append(arrs)
    recv, over = _exchange(shard_arrs, buckets, n_shards, cap, fills,
                           mesh, axis)
    ok = [o.sum() == 0 for o in psum(over, mesh, axis)]
    return [_local_sort(*r) for r in recv], ok


def _unzip(results, ok, n_out: int):
    cols = [[r[k] for r in results] for k in range(n_out)]
    counts = [r[-1] for r in results]
    return (*cols, counts, ok)


def sharded_sort_step(hi, lo, rows, s_hi, s_lo, *, mesh: Mesh,
                      axis: str = "shards", capacity_factor: float = 2.0):
    """One full sort exchange over the mesh.

    Inputs are sharded (one int64 tensor per shard, sentinel-padded);
    the splitters replicated (one copy per shard). Returns ``(hi, lo,
    rows, valid_counts, ok)`` as per-shard lists: each shard holds its
    key range ascending with a sentinel tail, so the shards trimmed to
    their counts and joined give the global order."""
    n_shards = mesh.shape[axis]
    per_shard = max(int(h.numel()) for h in hi)
    cap = _capacity(per_shard, capacity_factor, n_shards)
    results, ok = _sort_stage(hi, lo, rows, s_hi, s_lo, mesh=mesh,
                              axis=axis, n_shards=n_shards, cap=cap)
    return _unzip(results, ok, 3)


def _sort_stage_payload(hi, lo, rows, vals, s_hi, s_lo, *, mesh: Mesh,
                        axis: str, n_shards: int, cap: int):
    """As ``_sort_stage``, with a ``(m, W)`` payload per shard riding
    the exchange: whole records move, not just keys."""
    return _sort_stage(hi, lo, rows, s_hi, s_lo, mesh=mesh, axis=axis,
                       n_shards=n_shards, cap=cap, vals=vals)


def sharded_sort_payload_step(hi, lo, rows, vals, s_hi, s_lo, *,
                              mesh: Mesh, axis: str = "shards",
                              capacity_factor: float = 2.0):
    """One sort exchange moving keys and a per-shard ``(m, W)`` int32
    payload (the packed record words)."""
    n_shards = mesh.shape[axis]
    per_shard = max(int(h.numel()) for h in hi)
    cap = _capacity(per_shard, capacity_factor, n_shards)
    results, ok = _sort_stage_payload(hi, lo, rows, vals, s_hi, s_lo,
                                      mesh=mesh, axis=axis,
                                      n_shards=n_shards, cap=cap)
    return _unzip(results, ok, 4)


# Packed fixed-column layout for the record exchange (u32 words):
_PAYLOAD_COLS = (
    "refid", "pos", "flag_mapq", "bin", "next_refid", "next_pos", "tlen",
    # ragged section byte lengths (name, cigar, seq, qual, tags); the
    # offsets are rebuilt from them by prefix sum after the sort
    "len_name", "len_cig", "len_seq", "len_qual", "len_tag",
)

# Caps of the padded matrix: per-record ragged bytes and the whole matrix
# (a batch past them takes the host argsort instead).
_MAX_RAGGED_BYTES = 64 * 1024
_MAX_RAGGED_MATRIX = 2 << 30


def _ragged_lens(batch):
    name_len = np.diff(batch.name_offsets).astype(np.int64)
    cig_len = (np.diff(batch.cigar_offsets) * 4).astype(np.int64)
    seq_len = np.diff(batch.seq_offsets).astype(np.int64)
    tag_len = np.diff(batch.tag_offsets).astype(np.int64)
    return (name_len, cig_len, seq_len, seq_len, tag_len)


def _ragged_scatter(batch, lens, parent_u32: np.ndarray,
                    col_off_words: int) -> None:
    """Pack each record's ragged bytes (name|cigar|seq|qual|tags) into
    ``parent_u32[i, col_off_words:]`` by flat byte indexing into the
    contiguous parent."""
    n = batch.count
    assert parent_u32.flags.c_contiguous
    flat = parent_u32.view(np.uint8).reshape(-1)
    stride = parent_u32.shape[1] * 4
    sources = (
        batch.names,
        np.ascontiguousarray(batch.cigars).view(np.uint8)
        if batch.cigars.size else np.zeros(0, np.uint8),
        batch.seqs, batch.quals, batch.tags,
    )
    start = np.zeros(n, dtype=np.int64)
    row_base = np.arange(n, dtype=np.int64) * stride + col_off_words * 4
    for ln, src in zip(lens, sources):
        tot = int(ln.sum())
        if tot:
            intra = np.arange(tot, dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(ln)[:-1]]), ln)
            dst = np.repeat(row_base + start, ln) + intra
            flat[dst] = np.asarray(src, dtype=np.uint8)[:tot]
        start += ln


def _rebuild_ragged(parent_u32: np.ndarray, col_off_words: int,
                    lens_cols: np.ndarray):
    """Inverse of ``_ragged_scatter`` for the exchanged rows: ``(n, W)``
    u32 + ``(n, 5)`` lengths → per-section joined bytes and offsets."""
    n = parent_u32.shape[0]
    parent_u32 = np.ascontiguousarray(parent_u32)
    flat = parent_u32.view(np.uint8).reshape(-1)
    stride = parent_u32.shape[1] * 4
    row_base = np.arange(n, dtype=np.int64) * stride + col_off_words * 4
    start = np.zeros(n, dtype=np.int64)
    out = []
    for s in range(5):
        ln = lens_cols[:, s].astype(np.int64)
        tot = int(ln.sum())
        if tot:
            intra = np.arange(tot, dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(ln)[:-1]]), ln)
            src = np.repeat(row_base + start, ln) + intra
            data = flat[src]
        else:
            data = np.zeros(0, np.uint8)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ln, out=offs[1:])
        out.append((data, offs))
        start += ln
    return out


def _shard_rows(mesh: Mesh) -> Tuple[int, int]:
    """The ``[lo, hi)`` flat shard indices this process holds."""
    if mesh.distributed:
        per_host = mesh.size // mesh.process_count
        return mesh.process_index * per_host, \
            (mesh.process_index + 1) * per_host
    return 0, mesh.size


def _put_shards(mesh: Mesh, arrays: Sequence[np.ndarray],
                splitters: Sequence[np.ndarray]):
    """Host arrays shaped ``(n_shards, per_shard, ...)`` → this process's
    shards on their devices, and the splitters replicated on each."""
    from disq_tpu_torch.runtime import counters

    a, b = _shard_rows(mesh)
    devs = mesh.local_devices
    out = []
    for arr in arrays:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        parts = [t[i].to(d) for i, d in zip(range(a, b), devs)]
        if devs and devs[0].type == "cuda":
            counters.book_transfer("h2d", t[a:b].numel() * t.element_size())
        out.append(parts)
    for s in splitters:
        t = torch.from_numpy(np.ascontiguousarray(s).astype(np.int64))
        out.append([t.to(d) for d in devs])
    return out


def _host(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[np.ndarray]:
    """Per-shard tensors → host arrays of every shard of the job (the
    other processes' shards gathered over ``torch.distributed``)."""
    from disq_tpu_torch.runtime import counters

    local = [p.cpu().numpy() for p in parts]
    if parts and parts[0].is_cuda:
        counters.book_transfer("d2h", sum(x.nbytes for x in local))
    if not mesh.distributed:
        return local
    import torch.distributed as dist

    every: List = [None] * mesh.process_count
    dist.all_gather_object(every, local)
    return [x for proc in every for x in proc]


def _trimmed(parts, counts, mesh: Mesh) -> List[np.ndarray]:
    cnt = _host([c.reshape(1) for c in counts], mesh)
    arrs = _host(parts, mesh)
    return [a[: int(c[0])] for a, c in zip(arrs, cnt)]


def _all_ok(ok) -> bool:
    return all(bool(o) for o in ok)


def _two_level(mesh: Mesh, axis: str):
    """``(dcn_axis, ici_axis)`` of a two-axis mesh, checked: the trailing
    axis, named ``axis``, is the per-host one."""
    if mesh.axis_names[-1] != axis:
        raise ValueError(
            f"two-axis mesh must be (dcn_axis, {axis!r}) with the "
            f"per-host axis last; got {mesh.axis_names}")
    return mesh.axis_names


def sharded_sort_read_batch(batch, mesh: Optional[Mesh] = None,
                            axis: str = "shards",
                            capacity_factor: float = 2.0):
    """Coordinate-sort a ``ReadBatch`` with the whole record riding the
    exchange: fixed columns packed as u32 words and every ragged column
    packed into a padded byte matrix, moved by the same ``all_to_all``;
    the offsets are rebuilt from the carried section lengths. A
    ``(dcn, shards)`` mesh takes the two-level exchange. Returns
    ``(sorted_batch, permutation)``."""
    from disq_tpu_torch.bam.columnar import ReadBatch
    from disq_tpu_torch.sort.coordinate import coordinate_keys

    mesh = mesh or make_mesh()
    two_level = len(mesh.axis_names) == 2
    if two_level:
        dcn_axis, ici_axis = _two_level(mesh, axis)
    n_shards = mesh.size
    n = batch.count
    if n == 0:
        return batch, np.zeros(0, dtype=np.int64)
    keys = coordinate_keys(np.asarray(batch.refid), np.asarray(batch.pos))
    per_shard = -(-n // n_shards)
    padded = per_shard * n_shards
    keys_p = np.full(padded, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    keys_p[:n] = keys
    hi_p, lo_p = split_u64_keys(keys_p)
    rows_p = np.zeros(padded, dtype=np.uint32)
    rows_p[:n] = np.arange(n, dtype=np.uint32)
    lens = _ragged_lens(batch)
    rw_bytes = int(sum(lens).max()) if n else 0
    rw_words = -(-rw_bytes // 4)
    nfixed = len(_PAYLOAD_COLS)
    if (rw_bytes > _MAX_RAGGED_BYTES
            or padded * (nfixed + rw_words) * 4 > _MAX_RAGGED_MATRIX):
        order = np.argsort(keys, kind="stable")
        return batch.take(order), order
    vals_p = np.zeros((padded, nfixed + rw_words), dtype=np.uint32)
    _ragged_scatter(batch, lens, vals_p, nfixed)
    vals_p[:n, 0] = np.asarray(batch.refid).view(np.uint32)
    vals_p[:n, 1] = np.asarray(batch.pos).view(np.uint32)
    vals_p[:n, 2] = (
        np.asarray(batch.flag).astype(np.uint32)
        | (np.asarray(batch.mapq).astype(np.uint32) << 16)
    )
    vals_p[:n, 3] = np.asarray(batch.bin).astype(np.uint32)
    vals_p[:n, 4] = np.asarray(batch.next_refid).view(np.uint32)
    vals_p[:n, 5] = np.asarray(batch.next_pos).view(np.uint32)
    vals_p[:n, 6] = np.asarray(batch.tlen).view(np.uint32)
    for s in range(5):
        vals_p[:n, 7 + s] = lens[s].astype(np.uint32)
    s_hi, s_lo = split_u64_keys(sample_splitters(keys, n_shards))
    shp = (n_shards, per_shard)
    args = _put_shards(mesh, [
        hi_p.astype(np.int64).reshape(shp),
        lo_p.astype(np.int64).reshape(shp),
        rows_p.astype(np.int64).reshape(shp),
        vals_p.view(np.int32).reshape(shp + (-1,))], [s_hi, s_lo])
    for _ in range(3):
        if two_level:
            oh, ol, orows, ovals, counts, ok = hierarchical_sort_payload_step(
                *args, mesh=mesh, dcn_axis=dcn_axis, ici_axis=ici_axis,
                capacity_factor=capacity_factor)
        else:
            oh, ol, orows, ovals, counts, ok = sharded_sort_payload_step(
                *args, mesh=mesh, axis=axis,
                capacity_factor=capacity_factor)
        if _all_ok(ok):
            vh = np.concatenate(_trimmed(ovals, counts, mesh)).view(np.uint32)
            perm = np.concatenate(_trimmed(orows, counts, mesh)) \
                .astype(np.int64)
            (names, name_off), (cig_b, _cigoff), (seqs, seq_off), \
                (quals, _qoff), (tags, tag_off) = _rebuild_ragged(
                    vh, nfixed, vh[:, 7:12])
            cigars = np.ascontiguousarray(cig_b).view("<u4")
            cigar_off = np.zeros(len(vh) + 1, dtype=np.int64)
            np.cumsum(vh[:, 8].astype(np.int64) // 4, out=cigar_off[1:])
            sorted_batch = ReadBatch(
                refid=vh[:, 0].view(np.int32),
                pos=vh[:, 1].view(np.int32),
                mapq=(vh[:, 2] >> 16).astype(np.uint8),
                bin=vh[:, 3].astype(np.uint16),
                flag=(vh[:, 2] & 0xFFFF).astype(np.uint16),
                next_refid=vh[:, 4].view(np.int32),
                next_pos=vh[:, 5].view(np.int32),
                tlen=vh[:, 6].view(np.int32),
                name_offsets=name_off, names=names,
                cigar_offsets=cigar_off, cigars=cigars,
                seq_offsets=seq_off, seqs=seqs, quals=quals,
                tag_offsets=tag_off, tags=tags,
            )
            return sorted_batch, perm
        capacity_factor *= 2.0
    # skew defeated the capacity retries: the host argsort
    from disq_tpu_torch.sort.coordinate import coordinate_sort_batch

    order = np.argsort(keys, kind="stable")
    return coordinate_sort_batch(batch, use_mesh=False), order


def _keys_exchange_host_wrapper(
    keys_np: np.ndarray, n_shards: int, put, run,
    capacity_factor: float, max_retries: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The pad / splitter / retry / trim protocol around a keys-only
    exchange. ``put(hi, lo, rows, s_hi, s_lo, per_shard)`` places the
    padded host arrays on the mesh; ``run(args, cf)`` runs one exchange
    and returns ``(hi, lo, rows, counts, ok, mesh)``. A bucket overflow
    retries with twice the capacity; after ``max_retries`` the host
    argsort finishes."""
    n = len(keys_np)
    if n == 0:
        return keys_np.copy(), np.zeros(0, dtype=np.int64)
    per_shard = -(-n // n_shards)
    padded = per_shard * n_shards
    keys_p = np.full(padded, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    keys_p[:n] = keys_np
    hi_p, lo_p = split_u64_keys(keys_p)
    rows_p = np.zeros(padded, dtype=np.uint32)
    rows_p[:n] = np.arange(n, dtype=np.uint32)
    s_hi, s_lo = split_u64_keys(sample_splitters(keys_np, n_shards))
    args = put(hi_p, lo_p, rows_p, s_hi, s_lo, per_shard)
    for _ in range(max_retries):
        oh, ol, orows, counts, ok, mesh = run(args, capacity_factor)
        if _all_ok(ok):
            his = _trimmed(oh, counts, mesh)
            los = _trimmed(ol, counts, mesh)
            out_keys = np.concatenate([
                (h.astype(np.uint64) << np.uint64(32)) | l.astype(np.uint64)
                for h, l in zip(his, los)])
            out_rows = np.concatenate(_trimmed(orows, counts, mesh)) \
                .astype(np.int64)
            return out_keys, out_rows
        capacity_factor *= 2.0
    order = np.argsort(keys_np, kind="stable")
    return keys_np[order], order


def _keys_put(mesh: Mesh):
    def put(hi_p, lo_p, rows_p, s_hi, s_lo, per_shard):
        shp = (mesh.size, per_shard)
        return _put_shards(mesh, [
            hi_p.astype(np.int64).reshape(shp),
            lo_p.astype(np.int64).reshape(shp),
            rows_p.astype(np.int64).reshape(shp)], [s_hi, s_lo])
    return put


def sharded_coordinate_sort(
    keys_np: np.ndarray,
    mesh: Optional[Mesh] = None,
    axis: str = "shards",
    capacity_factor: float = 2.0,
    max_retries: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """u64 keys → (sorted keys, permutation) over the flat 1-D mesh
    exchange (protocol in ``_keys_exchange_host_wrapper``)."""
    mesh = mesh or make_mesh()

    def run(args, cf):
        return (*sharded_sort_step(*args, mesh=mesh, axis=axis,
                                   capacity_factor=cf), mesh)

    return _keys_exchange_host_wrapper(
        keys_np, mesh.shape[axis], _keys_put(mesh), run, capacity_factor,
        max_retries)


# -- the two-level (dcn, shards) exchange -------------------------------------


def _host_of(mesh: Mesh, i: int, per_host: int) -> int:
    """The ``dcn`` coordinate of this process's ``i``-th shard."""
    return mesh.process_index if mesh.distributed else i // per_host


def _two_stage_exchange(arrs, fills, s_hi, s_lo, *, mesh: Mesh,
                        dcn_axis: str, ici_axis: str, n_hosts: int,
                        per_host: int, cap1: int, cap2: int):
    """Two-stage exchange of every shard's arrays (``arrs[i]``, whose
    first two entries are the hi / lo halves; trailing dims ride along):
    stage 1 groups by destination host and exchanges over ``dcn_axis``
    (each device with its same-ordinal peer on every other host), stage 2
    groups by destination device within the host and exchanges over
    ``ici_axis``. Returns (each shard's arrays, ok)."""
    n_shards = n_hosts * per_host
    dests, buckets = [], []
    for i, a in enumerate(arrs):
        hi, lo = a[0], a[1]
        dest = _dest_shard(hi, lo, s_hi[i], s_lo[i])
        dest = torch.where(_valid(hi, lo), dest,
                           torch.full_like(dest, n_shards))
        buckets.append(dest // per_host)      # the phantom goes to n_hosts
    arrs1, over1 = _exchange(arrs, buckets, n_hosts, cap1, fills, mesh,
                             dcn_axis)
    buckets = []
    for i, a in enumerate(arrs1):
        hi, lo = a[0], a[1]
        dest = _dest_shard(hi, lo, s_hi[i], s_lo[i])
        local = dest - _host_of(mesh, i, per_host) * per_host
        buckets.append(torch.where(_valid(hi, lo), local,
                                   torch.full_like(local, per_host)))
    final, over2 = _exchange(arrs1, buckets, per_host, cap2, fills, mesh,
                             ici_axis)
    over = psum([a + b for a, b in zip(over1, over2)], mesh,
                (dcn_axis, ici_axis))
    return final, [o.sum() == 0 for o in over]


def _hier_geometry(mesh: Mesh, dcn_axis, ici_axis, per_shard,
                   capacity_factor):
    """``(n_hosts, per_host, cap1, cap2)``: the two-stage capacities."""
    n_hosts = mesh.shape[dcn_axis]
    per_host = mesh.shape[ici_axis]
    cap1 = max(1, min(int(per_shard * capacity_factor / n_hosts) + 1,
                      per_shard))
    cap2 = max(1, min(int(per_shard * capacity_factor / per_host) + 1,
                      n_hosts * cap1))
    return n_hosts, per_host, cap1, cap2


def _sort_stage_2level(hi, lo, rows, s_hi, s_lo, *, mesh: Mesh,
                       dcn_axis: str, ici_axis: str, n_hosts: int,
                       per_host: int, cap1: int, cap2: int, vals=None):
    """The keys-only two-stage body over a ``(dcn, shards)`` mesh: device
    (h, j) ends with global range chunk ``h * per_host + j``, so the
    joined order matches the flat exchange."""
    fills = (SENT32, SENT32, 0) + ((0,) if vals is not None else ())
    arrs = [[hi[i], lo[i], rows[i]] + ([vals[i]] if vals is not None
                                       else []) for i in range(len(hi))]
    final, ok = _two_stage_exchange(
        arrs, fills, s_hi, s_lo, mesh=mesh, dcn_axis=dcn_axis,
        ici_axis=ici_axis, n_hosts=n_hosts, per_host=per_host, cap1=cap1,
        cap2=cap2)
    # (hi, lo, row) order: duplicate keys in input order on this shape too
    return [_local_sort(*a) for a in final], ok


def _sort_stage_2level_payload(hi, lo, rows, vals, s_hi, s_lo, *,
                               mesh: Mesh, dcn_axis: str, ici_axis: str,
                               n_hosts: int, per_host: int, cap1: int,
                               cap2: int):
    """As ``_sort_stage_2level`` with the whole record riding both
    stages."""
    return _sort_stage_2level(hi, lo, rows, s_hi, s_lo, mesh=mesh,
                              dcn_axis=dcn_axis, ici_axis=ici_axis,
                              n_hosts=n_hosts, per_host=per_host,
                              cap1=cap1, cap2=cap2, vals=vals)


def hierarchical_sort_step(hi, lo, rows, s_hi, s_lo, *, mesh: Mesh,
                           dcn_axis: str = "dcn", ici_axis: str = "shards",
                           capacity_factor: float = 2.0):
    """One two-stage sort exchange over a ``(dcn, shards)`` mesh, with
    ``sharded_sort_step``'s inputs and outputs (shards in the mesh's
    flat order)."""
    per_shard = max(int(h.numel()) for h in hi)
    n_hosts, per_host, cap1, cap2 = _hier_geometry(
        mesh, dcn_axis, ici_axis, per_shard, capacity_factor)
    results, ok = _sort_stage_2level(
        hi, lo, rows, s_hi, s_lo, mesh=mesh, dcn_axis=dcn_axis,
        ici_axis=ici_axis, n_hosts=n_hosts, per_host=per_host, cap1=cap1,
        cap2=cap2)
    return _unzip(results, ok, 3)


def hierarchical_sort_payload_step(hi, lo, rows, vals, s_hi, s_lo, *,
                                   mesh: Mesh, dcn_axis: str = "dcn",
                                   ici_axis: str = "shards",
                                   capacity_factor: float = 2.0):
    """The two-stage exchange moving keys and the per-shard record
    payload: records cross ``dcn`` once in host-sized messages, then fan
    out over ``shards``."""
    per_shard = max(int(h.numel()) for h in hi)
    n_hosts, per_host, cap1, cap2 = _hier_geometry(
        mesh, dcn_axis, ici_axis, per_shard, capacity_factor)
    results, ok = _sort_stage_2level_payload(
        hi, lo, rows, vals, s_hi, s_lo, mesh=mesh, dcn_axis=dcn_axis,
        ici_axis=ici_axis, n_hosts=n_hosts, per_host=per_host, cap1=cap1,
        cap2=cap2)
    return _unzip(results, ok, 4)


def hierarchical_coordinate_sort(
    keys_np: np.ndarray, mesh: Mesh,
    dcn_axis: str = "dcn", ici_axis: str = "shards",
    capacity_factor: float = 2.0, max_retries: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """u64 keys → (sorted keys, permutation) over a ``(dcn, shards)``
    mesh (``runtime/multihost.global_mesh``), with
    ``sharded_coordinate_sort``'s contract and retries; the exchange runs
    in two stages so traffic between hosts crosses ``dcn`` once."""
    n_shards = mesh.shape[dcn_axis] * mesh.shape[ici_axis]

    def run(args, cf):
        return (*hierarchical_sort_step(
            *args, mesh=mesh, dcn_axis=dcn_axis, ici_axis=ici_axis,
            capacity_factor=cf), mesh)

    return _keys_exchange_host_wrapper(
        keys_np, n_shards, _keys_put(mesh), run, capacity_factor,
        max_retries)


# -- the resident sort: keys built on the shards, psum-histogram splitters ----


def _resident_keys_compiled(refid, pos, n: int):
    """(hi, lo, rows) of each shard of a batch-sharded refid / pos pair:
    the single-device key (unmapped → 0x7FFFFFFF in hi, pos + 1 in lo)
    and global row ids."""
    hi, lo, rows = [], [], []
    base = 0
    for r, p in zip(refid, pos):
        m = int(r.numel())
        rid = r.to(torch.int64)
        hi.append(torch.where(rid < 0, torch.full_like(rid, 0x7FFFFFFF),
                              rid))
        lo.append((p.to(torch.int64) + 1) & 0xFFFFFFFF)
        rows.append(torch.arange(base, base + m, dtype=torch.int64,
                                 device=r.device))
        base += m
    if base != n:
        raise ValueError(f"{base} rows on the shards for {n} records")
    return hi, lo, rows


def _key_byte(hi, lo, level: int):
    """Byte ``level`` (7 = most significant) of the (hi, lo) u64 key."""
    if level >= 4:
        return (hi >> (8 * (level - 4))) & 0xFF
    return (lo >> (8 * level)) & 0xFF


def _hist_level_compiled(hi, lo, pref: np.ndarray, level: int):
    """One level of the splitter search on one shard: the ``(n_cuts,
    256)`` histogram of key byte ``level`` over its keys whose higher
    bytes match each cut's resolved prefix."""
    n_cuts = pref.shape[0]
    mask = _valid(hi, lo)[None, :].expand(n_cuts, -1)
    if level < 7:
        up = torch.stack([_key_byte(hi, lo, u)
                          for u in range(level + 1, 8)])
        want = torch.from_numpy(pref[:, level + 1:].T.astype(np.int64)) \
            .to(hi.device)
        mask = mask & (up[:, None, :] == want[:, :, None]).all(0)
    tgt = _key_byte(hi, lo, level)
    comb = torch.arange(n_cuts, device=hi.device)[:, None] * 256 + tgt
    return torch.bincount(comb[mask], minlength=n_cuts * 256) \
        .reshape(n_cuts, 256)


def _psum_splitters(hi2, lo2, n: int, mesh: Mesh, axis: str,
                    n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact quantile splitters by MSB → LSB byte refinement over
    ``psum``-ed per-shard histograms: level 7 bins the top byte of every
    key; each cut takes the bin its target rank falls in, subtracts the
    mass below and descends, so after 8 levels the bytes are the key at
    that rank. Only the small table crosses to the host. Returns the
    (s_hi, s_lo) u32 halves."""
    from disq_tpu_torch.runtime import counters

    n_cuts = n_shards - 1
    if n_cuts <= 0 or n == 0:
        z = np.zeros(max(n_cuts, 0), dtype=np.uint32)
        return z, z.copy()
    remaining = np.array(
        [max(0, ((c + 1) * n) // n_shards - 1) for c in range(n_cuts)],
        dtype=np.int64)
    pref = np.full((n_cuts, 8), -1, dtype=np.int32)
    for level in range(7, -1, -1):
        parts = [_hist_level_compiled(h, l, pref, level)
                 for h, l in zip(hi2, lo2)]
        total = psum(parts, mesh, axis)[0]
        hist = total.cpu().numpy()
        if total.is_cuda:
            counters.book_transfer("h2d", pref.nbytes * len(parts))
            counters.book_transfer("d2h", hist.nbytes)
        cum = np.cumsum(hist, axis=1)
        for c in range(n_cuts):
            v = min(int(np.searchsorted(cum[c], remaining[c], side="right")),
                    255)
            pref[c, level] = v
            if v > 0:
                remaining[c] -= int(cum[c, v - 1])
    key = np.zeros(n_cuts, dtype=np.uint64)
    for level in range(8):
        key |= pref[:, level].astype(np.uint64) << np.uint64(8 * level)
    return split_u64_keys(key)


def resident_coordinate_sort(
    refid_dev, pos_dev, n: int, mesh: Mesh,
    axis: Optional[str] = None,
    capacity_factor: float = 2.0, max_retries: int = 3,
) -> np.ndarray:
    """Coordinate sort of a resident batch-sharded refid / pos pair (one
    tensor per shard): the keys are built on the shards, the splitters
    come from ``psum``-ed histograms and the range exchange runs over the
    mesh; only the histogram tables and the final permutation cross to
    the host. The permutation equals ``np.argsort(keys, kind="stable")``
    exactly, so a sorted BAM + BAI built from it is the single-device
    output's at any shard count."""
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.mesh import MESH_AXIS
    from disq_tpu_torch.runtime.tracing import device_span

    if axis is None:
        axis = MESH_AXIS if MESH_AXIS in mesh.axis_names \
            else mesh.axis_names[0]
    n_shards = int(mesh.shape[axis])
    with device_span("device.kernel", kernel="mesh_sort_keys",
                     records=n, devices=n_shards) as fence:
        hi2, lo2, rows2 = _resident_keys_compiled(refid_dev, pos_dev, n)
        fence.sync(rows2[-1])
    s_hi_np, s_lo_np = _psum_splitters(hi2, lo2, n, mesh, axis, n_shards)
    devs = mesh.local_devices
    s_hi = [torch.from_numpy(s_hi_np.astype(np.int64)).to(d) for d in devs]
    s_lo = [torch.from_numpy(s_lo_np.astype(np.int64)).to(d) for d in devs]
    if devs[0].type == "cuda":
        counters.book_transfer("h2d", (s_hi_np.nbytes + s_lo_np.nbytes)
                               * len(devs))
    cf = capacity_factor
    for _ in range(max_retries):
        with device_span("device.kernel", kernel="mesh_sort_exchange",
                         records=n, devices=n_shards) as fence:
            oh, ol, orows, counts, ok = sharded_sort_step(
                hi2, lo2, rows2, s_hi, s_lo, mesh=mesh, axis=axis,
                capacity_factor=cf)
            fence.sync(counts[-1])
        if _all_ok(ok):
            return np.concatenate(_trimmed(orows, counts, mesh)) \
                .astype(np.int64)
        cf *= 2.0
    # skew defeated the capacity retries: the keys come to the host once
    # and the host argsort finishes
    hi_h = np.concatenate(_host(hi2, mesh))
    lo_h = np.concatenate(_host(lo2, mesh))
    keys = (hi_h.astype(np.uint64) << np.uint64(32)) | lo_h.astype(np.uint64)
    return np.argsort(keys, kind="stable")

