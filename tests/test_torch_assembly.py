"""The port's codestream assembly from section byte images, on the CPU,
against the bit-item round trip it replaced, kept here as the oracle:
every section wrapped as one 8-bit item a byte (BitWriter.from_packed),
appended to the headers' writer (append_writer) after the TOC, and the
whole stream packed again (to_bytes).

(a) assemble_codestream on synthetic sections: bit counts 1, 7, 8, 9 and
    13, byte sizes on each side of every TOC class boundary, and the
    one-group frame whose four sections share one TOC entry; random bits
    past each section's bit count, in its last byte and its last word
(b) _SectionPlan.read on the compacted and the per-row layouts, on one
    rank and on two (a mesh whose second rank's buffers are the first's
    XOR a constant)
(c) the bit-level merge (span assembly.merge) opens once for a one-group
    image and never for a multi-group one"""
import os

import numpy as np
import pytest
import torch

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch import constants as C
from jxl_tiny_tpu_torch.bitstream import sections as S
from jxl_tiny_tpu_torch.bitstream.bit_writer import BitWriter
from jxl_tiny_tpu_torch.common import ImageDim, compute_distance_params
from jxl_tiny_tpu_torch.entropy import build_entropy_code
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.utils.profiling import StageTimer

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")


def _old_toc_and_sections(writer, sections):
    """The assembly before byte images: sections as writers of bit items,
    a one-group frame's four merged, each packed and appended byte by byte."""
    if len(sections) == 4:
        merged = BitWriter()
        for s in sections:
            merged.append_writer(s)
        sections = [merged]
    writer.write(1, 0)
    writer.zero_pad_to_byte()
    for s in sections:
        size = (s.bits_written + 7) // 8
        offset = 0
        for i, nb in enumerate((10, 14, 22, 30)):
            if size < offset + (1 << nb):
                writer.write(2, i)
                writer.write(nb, size - offset)
                break
            offset += 1 << nb
    writer.zero_pad_to_byte()
    for s in sections:
        raw = s.to_bytes()
        writer.append_writer(BitWriter.from_packed(np.frombuffer(raw, np.uint8), 8 * len(raw)))


def _old_codestream(dim, distp, codes, dc_sections, ac_sections):
    dc_code, ac_code = codes
    dc_global, ac_global = BitWriter(), BitWriter()
    S.write_dc_global(dc_global, distp, dim.num_dc_groups, dc_code)
    S.write_ac_global(ac_global, dim.num_groups, ac_code)
    out = BitWriter()
    S.write_file_header(out, dim.xsize, dim.ysize)
    S.write_frame_header(out, distp.x_qm_scale, distp.epf_iters)
    _old_toc_and_sections(out, [
        dc_global, *[BitWriter.from_packed(r, n) for r, n in dc_sections],
        ac_global, *[BitWriter.from_packed(r, n) for r, n in ac_sections]])
    return out.to_bytes()


@pytest.fixture(scope="module")
def codes():
    """A DC and an AC code from random histograms: the globals they
    serialize are written alike on both sides."""
    rng = np.random.RandomState(3)
    return tuple(build_entropy_code(rng.randint(0, 50, (n, C.ALPHABET_SIZE)).astype(np.uint32))
                 for n in (C.NUM_DC_CONTEXTS, C.NUM_AC_CONTEXTS))


def _section(rng, nbits, slack_words=1):
    """A section of `nbits` bits as program B leaves it: whole 32-bit words
    of random bits, the bits past `nbits` random too (in the last byte, the
    last word and `slack_words` words after it)."""
    words = rng.randint(0, 1 << 32, (nbits + 31) // 32 + slack_words, dtype=np.uint64)
    return words.astype(np.uint32).view(np.uint8), nbits


CASES = [("bits", n) for n in (1, 7, 8, 9, 13)] + \
    [("bytes", n) for n in (1023, 1024, 17407, 17408, 4211711, 4211712)] + \
    [("one_group", n) for n in (1, 13)]


@pytest.mark.parametrize("kind,n", CASES, ids=[f"{k}{n}" for k, n in CASES])
def test_assembly_equals_bit_item_round_trip(codes, kind, n):
    """(a) The codestream from byte images equals the bit-item round trip:
    `bits`, every section of n bits on a frame of 2 groups; `bytes`, one
    AC section of n bytes (its last byte partial) beside small ones;
    `one_group`, the four sections of a 256x256 frame merged."""
    rng = np.random.RandomState(n)
    dim = ImageDim(256, 256) if kind == "one_group" else ImageDim(512, 256)
    distp = compute_distance_params(1.0)
    nbits = {"bits": [n, n], "bytes": [8 * n - 5, 77], "one_group": [n]}[kind]
    ac = [_section(rng, b) for b in nbits]
    dc = [_section(rng, 8 * n + 3 if kind != "bytes" else 9)]
    assert len(ac) == dim.num_groups and len(dc) == dim.num_dc_groups
    timer = StageTimer()
    with timer.collect():
        got = TE.assemble_codestream(None, dim, distp, ac_sections=ac, ac_code=codes[1],
                                     dc_sections=dc, dc_code=codes[0])
    assert isinstance(got, bytes)
    assert got == _old_codestream(dim, distp, codes, dc, ac)
    assert timer.calls.get("assembly.merge", 0) == (kind == "one_group")
    assert timer.calls["assembly.toc"] == timer.calls["assembly.bytes"] == 1


class _TwoRanks:
    """A mesh of two ranks for _SectionPlan.read: rank 1's buffers are
    rank 0's XOR a constant (the same shapes, other words)."""

    size = 2
    KEY = 0x5A3C96E1

    def gather0(self, flat):
        return torch.stack([flat, flat ^ self.KEY])


def _plan_buffers(rng, plan, bits, ow, wcap, compact):
    """One rank's word buffer (compacted [wcap] or per-row [ng, ow], int32,
    random past every section) and the sections' word offsets in it."""
    per = len(bits) // plan.shards
    if not compact:
        return rng.randint(-(1 << 31), 1 << 31, (per, ow)).astype(np.int32), \
            np.zeros(len(bits), np.int64)
    nblk = (bits + 32 * 128 - 1) // (32 * 128)
    offs = np.zeros(len(bits), np.int64)
    for r in range(plan.shards):
        blk = nblk[r * per: (r + 1) * per]
        offs[r * per: (r + 1) * per] = np.concatenate([[0], np.cumsum(blk)[:-1]]) * 128
    return rng.randint(-(1 << 31), 1 << 31, wcap).astype(np.int32), offs


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("compact", [True, False], ids=["compacted", "per_row"])
def test_section_plan_read_gives_byte_images(compact, shards):
    """(b) Every section _SectionPlan.read returns, its bytes with the bits
    past its count cleared, equals the bit-item round trip of the same
    words; on a mesh, section k comes from rank k // (ng / shards)."""
    rng = np.random.RandomState(10 * shards + compact)
    plan = TE._SectionPlan(1, 4 * shards, 2 * shards, 8192, shards=shards)
    plan.compact_ac = plan.compact_dc = compact
    ac_bits = np.array([1, 7, 8, 9, 13, 40000, 0, 4097][: plan.ng], np.int64)
    dc_bits = np.array([31, 8 * 1023 + 1, 33, 64][: plan.ngd], np.int64)
    ac_words, ac_offs = _plan_buffers(rng, plan, ac_bits, plan.ow, plan.wcap, compact)
    dc_words, dc_offs = _plan_buffers(rng, plan, dc_bits, plan.ow_dc, plan.wcap_dc, compact)
    small = np.concatenate([ac_bits, ac_offs, dc_bits, dc_offs,
                            np.zeros(plan.ng + 2, np.int64)])
    out_b = {"ac_words": torch.from_numpy(ac_words), "dc_words": torch.from_numpy(dc_words)}
    got = plan.read(out_b, small, mesh=_TwoRanks() if shards == 2 else None)
    for secs, words, bits, offs in ((got[0], ac_words, ac_bits, ac_offs),
                                    (got[1], dc_words, dc_bits, dc_offs)):
        per = len(bits) // shards
        ranks = [words, words ^ np.int32(_TwoRanks.KEY)][:shards]
        assert len(secs) == len(bits)
        for k, (raw, nb) in enumerate(secs):
            assert raw.dtype == np.uint8 and nb == bits[k]
            rank = ranks[k // per]
            row = rank[offs[k]:] if compact else rank[k % per]
            want = BitWriter.from_packed(row[: (nb + 31) // 32].view(np.uint8), nb)
            assert S.join_sections(b"", [(raw, nb)]) == want.to_bytes(), k


@pytest.mark.parametrize("name,merges", [("photo256", 1), ("gradient512", 0)])
def test_merge_opens_for_one_group_frames_only(name, merges):
    """(c) photo256 is one group (4 sections, one TOC entry): the bit-level
    merge runs once; gradient512's 4 groups take the byte path alone."""
    img = read_pfm(os.path.join(TESTDATA, f"{name}.pfm"))
    timer = StageTimer()
    with timer.collect():
        data = TE.encode_image_device(img, 1.0, device="cpu")
    assert len(data) == {"photo256": 3426, "gradient512": 11680}[name]
    assert timer.calls.get("assembly.merge", 0) == merges
    assert timer.calls["assembly.sections"] == 1
