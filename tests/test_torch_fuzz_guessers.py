"""Property fuzz of the port's boundary guessers, the counterpart of
``tests/test_fuzz_guessers.py``, on the same seeded inputs: noise never
yields a block or record boundary that walks, every offset of a real
file finds the true next boundary (the reference's answer), and
truncations, splices and bit flips never crash the walkers or make them
mis-walk silently."""

import struct
import zlib

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.bam.guesser import BamRecordGuesser as RefRecordGuesser
from disq_tpu.bgzf.guesser import BgzfBlockGuesser as RefBlockGuesser
from disq_tpu.fsw.filesystem import resolve_path as ref_resolve
from disq_tpu_torch.bam.guesser import BamRecordGuesser
from disq_tpu_torch.bgzf.codec import compress_to_bgzf, decompress_bgzf
from disq_tpu_torch.bgzf.codec import inflate_blocks
from disq_tpu_torch.bgzf.guesser import (
    BgzfBlockGuesser,
    find_block_table,
    walk_blocks_collect,
)
from disq_tpu_torch.fsw.filesystem import resolve_path

LENGTHS = [ln for _, ln in DEFAULT_REFS]


def _write(tmp_path, name, data: bytes) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


class TestBgzfGuesserFuzz:
    def test_random_soup_no_false_blocks(self, tmp_path):
        rng = np.random.default_rng(0)
        for trial in range(20):
            soup = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
            p = _write(tmp_path, f"soup{trial}", soup)
            g = BgzfBlockGuesser(*resolve_path(p))
            start = g.guess_block_start(0)
            assert start == RefBlockGuesser(*ref_resolve(p)) \
                .guess_block_start(0)
            if start is not None:
                fs, q = resolve_path(p)
                with pytest.raises(ValueError):
                    walk_blocks_collect(fs, q, start, len(soup), len(soup))

    def test_every_offset_finds_true_boundary(self, tmp_path):
        rng = np.random.default_rng(1)
        payload = rng.integers(0, 64, 150_000, dtype=np.uint8).tobytes()
        data = compress_to_bgzf(payload)
        p = _write(tmp_path, "real.bgz", data)
        fs, q = resolve_path(p)
        truth = [b.pos for b in find_block_table(fs, q)]
        g = BgzfBlockGuesser(fs, q)
        ti = 0
        for off in range(len(data)):
            while ti < len(truth) and truth[ti] < off:
                ti += 1
            want = truth[ti] if ti < len(truth) else None
            assert g.guess_block_start(off) == want, off

    def test_header_spliced_into_noise(self, tmp_path):
        rng = np.random.default_rng(2)
        real = compress_to_bgzf(b"x" * 100_000)
        soup = bytearray(rng.integers(0, 256, 120_000,
                                      dtype=np.uint8).tobytes())
        soup[5_000: 5_000 + 18] = real[:18]
        p = _write(tmp_path, "spliced", bytes(soup))
        fs, q = resolve_path(p)
        s = BgzfBlockGuesser(fs, q).guess_block_start(0)
        assert s == RefBlockGuesser(*ref_resolve(p)).guess_block_start(0)
        if s is not None:
            with pytest.raises(ValueError):
                walk_blocks_collect(fs, q, s, len(soup), len(soup))

    @pytest.mark.parametrize("cut", [1, 7, 17, 18, 19, 100])
    def test_truncations_never_crash(self, tmp_path, cut):
        data = compress_to_bgzf(b"payload" * 5000)
        p = _write(tmp_path, f"trunc{cut}", data[: len(data) - cut])
        g = BgzfBlockGuesser(*resolve_path(p))
        try:
            blocks = g.blocks_in_split(0, len(data))
            assert all(b.end <= len(data) - cut for b in blocks)
        except ValueError:
            pass  # a loud failure is the other acceptable outcome

    def test_bit_flips_detected_or_recovered(self, tmp_path):
        rng = np.random.default_rng(3)
        payload = bytes(rng.integers(0, 16, 80_000, dtype=np.uint8))
        data = bytearray(compress_to_bgzf(payload))
        for trial in range(30):
            mutated = bytearray(data)
            i = int(rng.integers(0, len(data)))
            mutated[i] ^= 1 << int(rng.integers(0, 8))
            p = _write(tmp_path, f"flip{trial}", bytes(mutated))
            fs, q = resolve_path(p)
            try:
                blocks, staged = walk_blocks_collect(
                    fs, q, 0, len(mutated), len(mutated))
                out = inflate_blocks(staged, blocks, base=0)
                # accepted: the flip is in dead space (header padding)
                assert bytes(out) == payload
            except (ValueError, zlib.error):
                pass


def _records(n=400, seed=0):
    data = make_bam_bytes(DEFAULT_REFS, synth_records(n, seed=seed))
    blob = decompress_bgzf(data)
    (l_text,) = struct.unpack_from("<i", blob, 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", blob, p)
    p += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", blob, p)
        p += 4 + l_name + 4
    return np.frombuffer(blob[p:], dtype=np.uint8), n_ref


def _truth(records: np.ndarray):
    blob = records.tobytes()
    out, p = [], 0
    while p < len(blob):
        out.append(p)
        (bs,) = struct.unpack_from("<i", blob, p)
        p += 4 + bs
    return out


class TestBamGuesserFuzz:
    def test_random_soup_no_false_records(self):
        rng = np.random.default_rng(4)
        g = BamRecordGuesser(n_ref=3, ref_lengths=LENGTHS)
        ref = RefRecordGuesser(n_ref=3, ref_lengths=LENGTHS)
        hits = 0
        for _ in range(20):
            soup = rng.integers(0, 256, 100_000, dtype=np.uint8)
            r = g.find_first_record(soup)
            assert r == ref.find_first_record(soup)
            hits += r is not None
        assert hits <= 1

    def test_every_offset_recovers_record_grid(self):
        records, n_ref = _records()
        g = BamRecordGuesser(n_ref=n_ref, ref_lengths=LENGTHS)
        truth = _truth(records)
        probes = list(range(int(truth[3]))) + [
            int(x) for x in np.linspace(0, len(records) - 40, 200)]
        for off in probes:
            found = g.find_first_record(records[off:])
            want = next((t for t in truth if t >= off), None)
            if want is None:
                continue
            assert found is not None and off + found == want, off

    def test_corrupted_records_dont_confuse_guesser(self):
        rng = np.random.default_rng(5)
        records, n_ref = _records()
        truth = set(_truth(records))
        g = BamRecordGuesser(n_ref=n_ref, ref_lengths=LENGTHS)
        ref = RefRecordGuesser(n_ref=n_ref, ref_lengths=LENGTHS)
        for _ in range(20):
            mutated = records.copy()
            i = int(rng.integers(len(records) // 2, len(records)))
            mutated[i] ^= 0xFF
            r = g.find_first_record(mutated)
            assert r is not None and r in truth, (i, r)
            assert r == ref.find_first_record(mutated)
