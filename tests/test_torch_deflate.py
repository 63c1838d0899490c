"""The port's device deflate on the CPU, held byte for byte against the JAX package.

``disq_tpu_torch.ops.deflate`` (the host table code, the plain version
of kernel W2, the BGZF framing and fallbacks) and the plain version of
kernel W1 (``ops/record_gather.py``):

- package-merge code lengths and canonical codes equal the reference's
  on seeded random alphabets, on skewed ones where the 15-bit limit
  binds, and on a single symbol; every ``DeflateTable`` field that
  decides bytes equals the reference's;
- ``encode_plain`` rows and end bits equal the reference's batched
  encoder (``_compiled``) on the same payloads and table;
- ``deflate_blob_device(…, device="cpu")`` bytes, block sizes and
  ``last_stats`` equal the reference's, from empty to two blocks, on
  BAM-like, incompressible (stored fallback) and repetitive payloads,
  and every block's stream inflates with ``zlib.decompress(s, -15)``;
- ``gather_plain`` equals a numpy gather of the same records.

Tolerance is 0 everywhere: these are bytes.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import disq_tpu.ops.deflate as RD
from disq_tpu_torch.ops import deflate as DF
from disq_tpu_torch.ops import record_gather as W1

BLOCK = DF.BLOCK_PAYLOAD


def _random_freqs(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 258))
    freq = np.zeros(257, np.int64)
    freq[rng.choice(257, k, replace=False)] = rng.integers(1, 100_000, k)
    return freq


def _fibonacci_freqs(n):
    freq = np.zeros(n, np.int64)
    a, b = 1, 1
    for i in range(n):
        freq[i] = min(a, 1 << 40)
        a, b = b, a + b
    return freq


@pytest.mark.parametrize("seed", range(12))
def test_huffman_lengths_and_codes_random(seed):
    freq = _random_freqs(seed)
    lens = DF.limited_huffman_lengths(freq, 15)
    want = RD.limited_huffman_lengths(freq, 15)
    assert lens.dtype == want.dtype and np.array_equal(lens, want)
    assert np.array_equal(DF.canonical_codes(lens), RD.canonical_codes(want))


@pytest.mark.parametrize("n,limit", [(40, 15), (30, 15), (25, 7), (257, 15)])
def test_huffman_lengths_skewed_limit_binds(n, limit):
    freq = _fibonacci_freqs(n)
    lens = DF.limited_huffman_lengths(freq, limit)
    assert np.array_equal(lens, RD.limited_huffman_lengths(freq, limit))
    if n >= 30:
        assert lens.max() == limit
    kraft = float(np.sum(2.0 ** -lens[lens > 0].astype(float)))
    assert kraft == 1.0
    assert np.array_equal(DF.canonical_codes(lens), RD.canonical_codes(lens))


def test_huffman_single_symbol_and_empty():
    freq = np.zeros(10, np.int64)
    freq[3] = 7
    assert np.array_equal(DF.limited_huffman_lengths(freq, 15),
                          RD.limited_huffman_lengths(freq, 15))
    assert not DF.limited_huffman_lengths(np.zeros(5, np.int64), 15).any()


def _tables(freq, eob):
    return DF.DeflateTable(freq, eob), RD.DeflateTable(freq, eob)


_HISTOGRAMS = {
    "random": lambda: _random_freqs(99)[:256],
    "skewed": lambda: _fibonacci_freqs(256),
    "bam_like": lambda: np.bincount(
        np.random.default_rng(3).integers(0, 42, 50_000), minlength=256),
    "one_byte": lambda: np.eye(256, dtype=np.int64)[65] * 9,
}


@pytest.mark.parametrize("kind", sorted(_HISTOGRAMS))
def test_table_fields_equal_reference(kind):
    freq = _HISTOGRAMS[kind]()
    port, ref = _tables(freq, 3)
    assert np.array_equal(port.lit_lens, ref.lit_lens)
    for name in ("header_bits", "header_bytes", "eob_rev", "eob_len",
                 "max_code"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.out_bytes % 16 == 0
    assert port.out_bytes * 8 >= 4096 + BLOCK * port.max_code + 15
    code, length = port.luts("cpu")
    assert code.dtype == length.dtype == torch.int32
    assert np.array_equal(code.numpy(), ref._rev[:256])
    assert np.array_equal(length.numpy(), ref.lit_lens[:256])
    assert port.luts("cpu")[0] is code  # uploaded once per device


def _reference_rows(payloads, ref, out_bytes):
    """The reference's batched encoder on ``payloads`` (≤128 lanes)."""
    cw = RD.bucket_for(payloads)
    comp = np.zeros((cw, RD.LANES), np.uint32)
    clen = np.zeros((1, RD.LANES), np.int32)
    for j, p in enumerate(payloads):
        buf = np.zeros(cw * 4, np.uint8)
        buf[: len(p)] = np.frombuffer(p, np.uint8)
        comp[:, j] = buf.view("<u4")
        clen[0, j] = len(p)
    code, length = ref.luts()
    bodies, end = RD._compiled(cw, out_bytes)(
        jnp.asarray(comp), jnp.asarray(clen), code, length,
        jnp.int32(ref.header_bits))
    n = len(payloads)
    return np.asarray(bodies)[:n], np.asarray(end).reshape(-1)[:n]


def _port_rows(payloads, port):
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    off = np.concatenate([[0], np.cumsum([len(p) for p in payloads])])
    t = torch.from_numpy(blob.copy())
    bodies, end = DF.encode(
        t, torch.from_numpy(off[:-1].astype(np.int64)),
        torch.tensor([len(p) for p in payloads], dtype=torch.int32),
        *port.luts("cpu"), port.header_bits, port.out_bytes)
    return bodies.numpy(), end.numpy()


@pytest.mark.parametrize("case", ["bam_like", "skewed_long_codes",
                                  "edge_lengths"])
def test_encode_plain_equals_reference_encoder(case):
    rng = np.random.default_rng(7)
    if case == "bam_like":
        payloads = [rng.integers(0, 42, n, np.uint8).tobytes()
                    for n in (3000, 2048, 1, 4096)]
        freq = np.bincount(np.frombuffer(b"".join(payloads), np.uint8),
                           minlength=256)
    elif case == "skewed_long_codes":
        # every byte value present, most of them rare: 15-bit codes
        payloads = [rng.integers(0, 256, 1500, np.uint8).tobytes(),
                    bytes(range(256)) * 3]
        freq = _fibonacci_freqs(256)
    else:
        payloads = [b"\x07", rng.integers(0, 9, 255, np.uint8).tobytes(),
                    rng.integers(0, 9, 4099, np.uint8).tobytes(), b""]
        freq = np.bincount(np.frombuffer(b"".join(payloads), np.uint8),
                           minlength=256)
    port, ref = _tables(freq, len(payloads))
    if case == "skewed_long_codes":
        assert port.max_code == 15
    got_rows, got_end = _port_rows(payloads, port)
    want_rows, want_end = _reference_rows(payloads, ref, port.out_bytes)
    assert np.array_equal(got_end, want_end)
    assert np.array_equal(got_rows, want_rows)
    for j, p in enumerate(payloads):
        # zero below the header and from the end bit on
        assert not got_rows[j, : port.header_bits // 8].any()
        assert not got_rows[j, (int(got_end[j]) + 7) // 8:].any()


def test_encode_rejects_bad_arguments():
    t = torch.zeros(10, dtype=torch.uint8)
    off = torch.zeros(1, dtype=torch.int64)
    ln = torch.ones(1, dtype=torch.int32)
    lut = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="pay_len"):
        DF.encode(t, off, ln.long(), lut, lut, 10, 1024)
    with pytest.raises(ValueError, match="payload"):
        DF.encode(t.int(), off, ln, lut, lut, 10, 1024)
    with pytest.raises(ValueError, match="out_bytes"):
        DF.encode(t, off, ln, lut, lut, 10, 1000)
    with pytest.raises(ValueError, match="LUTs"):
        DF.encode(t, off, ln, lut[:10], lut[:10], 10, 1024)


def _payload(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "bam_like":
        return (rng.integers(0, 42, 150_000, np.uint8).tobytes()
                + rng.integers(0, 16, 150_000, np.uint8).tobytes())
    if kind == "incompressible":
        return rng.integers(0, 256, 130_000, np.uint8).tobytes()
    if kind == "repetitive":
        return b"ACGT" * 40_000
    n = int(kind)
    return np.random.default_rng(n).integers(0, 5, n, np.uint8).tobytes()


def _streams(comp, sizes):
    pos = 0
    for s in sizes:
        xlen = struct.unpack_from("<H", comp, pos + 10)[0]
        crc, isize = struct.unpack_from("<II", comp, pos + int(s) - 8)
        yield comp[pos + 12 + xlen: pos + int(s) - 8], crc, isize
        pos += int(s)
    assert pos == len(comp)


@pytest.mark.parametrize("kind", ["0", "1", "2", "255", str(BLOCK),
                                  str(BLOCK + 1), "bam_like",
                                  "incompressible", "repetitive"])
def test_deflate_blob_device_equals_reference(kind):
    payload = _payload(kind)
    comp, sizes = DF.deflate_blob_device(payload, device="cpu")
    stats = dict(DF.last_stats)
    want_comp, want_sizes = RD.deflate_blob_device(payload)
    assert comp == want_comp
    assert np.array_equal(sizes, want_sizes)
    assert stats == RD.last_stats
    out = bytearray()
    for stream, crc, isize in _streams(comp, sizes):
        data = zlib.decompress(stream, -15)
        assert len(data) == isize and zlib.crc32(data) == crc
        out += data
    assert bytes(out) == payload
    if kind == "incompressible":
        assert stats["stored_fallback"] == stats["blocks"] == 2
    if kind == "bam_like":
        assert len(comp) < len(payload) and stats["host_fallback"] == 0


def test_bgzf_codec_routes_by_device():
    from disq_tpu_torch.bgzf.codec import compress_to_bgzf, deflate_blob

    payload = b"the device write path" * 4000
    assert deflate_blob(payload, device="cpu")[0] == \
        RD.deflate_blob_device(payload)[0]
    assert deflate_blob(payload)[0] != deflate_blob(payload, device="cpu")[0]
    assert compress_to_bgzf(payload, device="cpu").startswith(
        deflate_blob(payload, device="cpu")[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_plain_equals_numpy(seed):
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, 5000, np.uint8)
    n = 40
    lens = rng.integers(0, 60, n)
    src = rng.integers(0, 5000 - 60, n)
    dst = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    got = W1.gather_records(torch.from_numpy(blob),
                            torch.from_numpy(src.astype(np.int64)),
                            torch.from_numpy(dst), int(dst[-1]))
    want = np.concatenate([blob[s: s + n] for s, n in zip(src, lens)])
    assert np.array_equal(got.numpy(), want)


def test_gather_rejects_bad_arguments():
    blob = torch.zeros(10, dtype=torch.uint8)
    src = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="offsets"):
        W1.gather_records(blob, src, torch.zeros(2, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="src"):
        W1.gather_records(blob, src.int(), torch.zeros(3, dtype=torch.int64),
                          0)
