"""Hostile input to the port's decoders, the counterpart of
``tests/test_fuzz_decoders.py``: the CRAM container reader
(``decode_container_records``), the plain versions of the inflate
kernel (B1, through ``inflate_payloads_simd``) and of the rANS kernels
(B3, B5), and whole BAM and CRAM reads. Garbage must fail cleanly — a
Python exception, never a hang, a crash or a silent success — and where
the reference decodes the same bytes, the port gives its result or its
failure exactly.
"""

import struct
import zlib

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, encode_record, make_bam_bytes, \
    synth_records

CLEAN = (ValueError, IndexError, KeyError, OverflowError, MemoryError,
         zlib.error, EOFError, struct.error)


def _container():
    """The block section of one reference-written data container."""
    from disq_tpu.bam.codec import decode_records
    from disq_tpu.cram.codec import encode_container
    from disq_tpu.cram.io import Cursor
    from disq_tpu.cram.structure import ContainerHeader

    blob = b"".join(encode_record(r) for r in synth_records(60, seed=41))
    batch = decode_records(blob)
    one = batch.take(np.flatnonzero(np.asarray(batch.refid) == 0))
    data, _ = encode_container(one, 0, 0)
    cur = Cursor(data)
    ContainerHeader.read(cur)
    return bytes(data[cur.off:])


def _outcome(fn, data):
    try:
        return fn(data), None
    except Exception as e:  # noqa: BLE001 — classified by the caller
        return None, e


def _same_batch(a, b):
    for f in ("refid", "pos", "flag", "names", "cigars", "seqs", "quals",
              "tags"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


class TestCramReaderFuzz:
    def test_bitflips_fail_cleanly_as_the_reference_does(self):
        from disq_tpu.cram.codec import decode_container_records as ref_dec
        from disq_tpu_torch.cram.codec import decode_container_records

        rng = np.random.default_rng(99)
        base = bytearray(_container())
        clean = 0
        for _trial in range(120):
            mutated = bytearray(base)
            for _ in range(int(rng.integers(1, 4))):
                mutated[int(rng.integers(0, len(mutated)))] ^= int(
                    rng.integers(1, 256))
            got, err = _outcome(decode_container_records, bytes(mutated))
            want, ref_err = _outcome(ref_dec, bytes(mutated))
            if err is not None:
                assert isinstance(err, CLEAN), repr(err)
                clean += 1
            elif ref_err is None:
                _same_batch(got, want)
        # the CRC32 of every block catches nearly every flip
        assert clean >= 110

    @pytest.mark.parametrize("frac", [0.1, 0.3, 0.7, 0.95])
    def test_truncations_raise(self, frac):
        from disq_tpu_torch.cram.codec import decode_container_records

        base = _container()
        with pytest.raises(CLEAN):
            decode_container_records(base[: int(len(base) * frac)])

    @pytest.mark.parametrize("n", [1, 10, 200, 5000])
    def test_random_garbage_raises(self, n):
        from disq_tpu_torch.cram.codec import decode_container_records

        junk = np.random.default_rng(n).integers(0, 256, n,
                                                 dtype=np.uint8).tobytes()
        with pytest.raises(CLEAN):
            decode_container_records(junk)


def _deflate(data):
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
    return c.compress(data) + c.flush()


class TestPlainInflateFuzz:
    def test_random_payloads_fail_cleanly(self):
        from disq_tpu_torch.ops.inflate_simd import inflate_payloads_simd

        rng = np.random.default_rng(99)
        payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                    for n in (4, 40, 300)]
        with pytest.raises(ValueError, match="corrupt DEFLATE"):
            inflate_payloads_simd(payloads, usizes=[512] * 3, device="cpu")

    def test_bitflipped_streams_detected_or_equal_to_zlib(self):
        """A mutated stream either fails somewhere on the path or decodes
        to exactly what host zlib gives: B1's plain version never
        diverges from zlib."""
        from disq_tpu_torch.ops.inflate_simd import inflate_payloads_simd

        rng = np.random.default_rng(99)
        raw = rng.integers(65, 91, 600, dtype=np.uint8).tobytes()
        base = bytearray(_deflate(raw))
        for trial in range(40):
            mutated = bytearray(base)
            mutated[int(rng.integers(0, len(mutated)))] ^= int(
                rng.integers(1, 256))
            mutated = bytes(mutated)
            want, want_err = _outcome(
                lambda m: zlib.decompress(m, wbits=-15), mutated)
            try:
                got = inflate_payloads_simd(
                    [mutated], usizes=[len(want) if want else 1024],
                    device="cpu")[0]
            except (zlib.error, ValueError):
                continue
            if want_err is None:
                assert got == want, f"trial {trial}: diverged from zlib"


class TestPlainRansFuzz:
    @pytest.mark.parametrize("decoder", ["b3", "b5"])
    def test_garbage_and_bitflips_as_the_reference_host_decoder(self,
                                                                decoder):
        """Random streams raise cleanly; a bit-flipped order-0 stream
        that the reference's host rANS decodes, the plain version decodes
        to the same bytes. (The kernels, the reference's and the port's,
        skip the host decoder's final-state test, so they may decode a
        stream the host rejects: the CRAM block's CRC is the arbiter.)"""
        from disq_tpu.cram.rans import rans_decode, rans_encode_order0
        from disq_tpu_torch.ops.rans import rans0_decode_device
        from disq_tpu_torch.ops.rans_simd import rans0_decode_simd

        fn = rans0_decode_simd if decoder == "b3" else rans0_decode_device
        rng = np.random.default_rng(7)
        for n in (1, 10, 200, 5000):
            junk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            with pytest.raises(CLEAN):
                fn([junk], "cpu")
        good = rans_encode_order0(
            rng.integers(65, 70, 1500, dtype=np.uint8).tobytes())
        decoded = 0
        for _trial in range(40):
            m = bytearray(good)
            m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
            m = bytes(m)
            want, want_err = _outcome(rans_decode, m)
            got, err = _outcome(lambda s: fn([s], "cpu")[0], m)
            if want_err is None:
                assert err is None and got == want
                decoded += 1
            elif err is not None:
                assert isinstance(err, CLEAN), repr(err)
        assert 0 < decoded < 40


class TestCorruptInputContract:
    def test_bam_and_cram_corruptions_raise_valueerror(self, tmp_path):
        """Random multi-byte corruption of whole BAM and CRAM files read
        through the port surfaces as ``ValueError``, never a raw codec
        exception or a crash."""
        import disq_tpu_torch as P

        recs = synth_records(800, seed=71, sorted_coord=True)
        bam = make_bam_bytes(DEFAULT_REFS, recs)
        st = P.ReadsStorage.make_default(device="cpu")
        (tmp_path / "in.bam").write_bytes(bam)
        ds = st.read(str(tmp_path / "in.bam"))
        st.write(ds, str(tmp_path / "o.cram"),
                 P.ReadsFormatWriteOption.CRAM)
        blobs = {".bam": bam, ".cram": (tmp_path / "o.cram").read_bytes()}
        rng = np.random.default_rng(5)
        seen_error = 0
        for trial in range(40):
            ext = ".bam" if trial % 2 else ".cram"
            src = bytearray(blobs[ext])
            for _ in range(int(rng.integers(1, 6))):
                src[int(rng.integers(0, len(src)))] ^= int(
                    rng.integers(1, 256))
            mut = tmp_path / f"m{trial}{ext}"
            mut.write_bytes(bytes(src))
            try:
                st.read(str(mut)).count()
            except ValueError:
                seen_error += 1
        assert seen_error > 20
