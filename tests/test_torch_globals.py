"""The port's DC and AC global sections (bitstream/sections.py), written as
item arrays with the DC global's frame-invariant bits built once a
num_dc_groups, on the CPU against the JAX package's writers, which write
one item at a time:

(a) the bytes and bit counts of both globals equal the JAX package's for
    codes from random histograms, single-symbol clusters, simple trees of
    up to four symbols, run-length-heavy uniform depths, an all-zero
    context map and every static candidate of load_static_codes, at
    num_dc_groups 1, 4, 16 and 30 and distances 0.5, 1.0 and 2.0
(b) the invariant bits are built (span assembly.globals.prefix) once a
    num_dc_groups, whatever the distance
(c) BitItems packs as a BitWriter does and refuses a value wider than
    its item"""
import dataclasses

import numpy as np
import pytest

from jxl_tiny_tpu.bitstream import BitWriter as JBitWriter
from jxl_tiny_tpu.bitstream import sections as JS
from jxl_tiny_tpu.common import compute_distance_params as j_distance_params
from jxl_tiny_tpu.entropy.entropy_write import EntropyCode as JCode

from jxl_tiny_tpu_torch import constants as C
from jxl_tiny_tpu_torch.bitstream import sections as S
from jxl_tiny_tpu_torch.bitstream.bit_writer import BitItems, BitWriter
from jxl_tiny_tpu_torch.common import compute_distance_params
from jxl_tiny_tpu_torch.entropy import build_entropy_code
from jxl_tiny_tpu_torch.entropy.entropy_write import (
    build_entropy_code_from_cluster_histograms, load_static_codes)
from jxl_tiny_tpu_torch.utils.profiling import StageTimer

NUM_CONTEXTS = (C.NUM_DC_CONTEXTS, C.NUM_AC_CONTEXTS)
# (num_dc_groups, num_groups) of four frames: one group; 3840x2160;
# 8192x7680; 6 DC groups wide and 5 high, its last ones partly filled.
GEOMETRIES = ((1, 1), (4, 135), (16, 960), (30, 1900))
DISTANCES = (0.5, 1.0, 2.0)


def _code(clusters, num_contexts, rng):
    """An EntropyCode of `clusters` (histograms, not clustered further)
    whose contexts draw their cluster at random, every cluster used."""
    code = build_entropy_code_from_cluster_histograms(np.asarray(clusters, np.uint32))
    m = code.num_clusters
    cmap = np.concatenate([np.arange(m), rng.randint(0, m, num_contexts - m)])
    return dataclasses.replace(code, context_map=rng.permutation(cmap).astype(np.uint8),
                               token_depths=None)


def _histograms(symbols_and_counts):
    h = np.zeros((len(symbols_and_counts), C.ALPHABET_SIZE), np.uint32)
    for i, (symbols, counts) in enumerate(symbols_and_counts):
        h[i, symbols] = counts
    return h


def _random(n, rng):
    h = rng.randint(0, 50, (n, C.ALPHABET_SIZE)).astype(np.uint32)
    h[:, 24:] = rng.randint(0, 3, (n, C.ALPHABET_SIZE - 24))
    return build_entropy_code(h)


def _single_symbol(n, rng):
    return _code(_histograms([([0], [5]), ([7], [3]), ([16], [1]), ([63], [9])]), n, rng)


def _simple_trees(n, rng):
    # Two, three and four symbols; four at depths 1, 2, 3, 3 and at 2, 2,
    # 2, 2; symbols out of their depths' order.
    return _code(_histograms([([3, 40], [1, 7]), ([9, 2, 33], [1, 5, 2]),
                              ([50, 1, 12, 6], [1, 8, 2, 4]), ([5, 6, 20, 61], [3, 3, 3, 3]),
                              ([0, 1, 2, 3], [2, 9, 1, 4])]), n, rng)


def _rle_uniform(n, rng):
    blocks = np.repeat([40, 40, 10, 10, 3, 3, 1, 1], 8)
    return _code(_histograms([(np.arange(64), 1),                      # depth 6 over all 64
                              (np.r_[0:8, 56:64], 1),                   # a run of 48 zeros
                              (np.arange(32), 1),                       # 32 symbols: no RLE
                              (np.r_[0:10, 14:64], 1),                  # 4 zeros: at the bar
                              (np.arange(64), blocks),                  # runs of equal depths
                              (np.r_[0:20, 40:64], np.r_[np.full(20, 7), np.full(24, 1)])]),
                 n, rng)


def _all_zero_map(n, rng):
    code = build_entropy_code(rng.randint(0, 30, (1, C.ALPHABET_SIZE)).astype(np.uint32))
    return dataclasses.replace(code, context_map=np.zeros(n, np.uint8))


CASES = [(name, make) for name, make in (("random", _random), ("single_symbol", _single_symbol),
                                         ("simple_trees", _simple_trees),
                                         ("rle_uniform", _rle_uniform),
                                         ("all_zero_map", _all_zero_map))]
CASES += [(f"static{k}", k) for k in range(len(load_static_codes().dc_codes))]
PARAMS = [pytest.param(name, make, *GEOMETRIES[i % len(GEOMETRIES)],
                       DISTANCES[i % len(DISTANCES)], id=name)
          for i, (name, make) in enumerate(CASES)]


def _codes(make, seed):
    if isinstance(make, int):
        static = load_static_codes()
        return static.dc_codes[make], static.ac_codes[make]
    rng = np.random.RandomState(seed)
    return tuple(make(n, rng) for n in NUM_CONTEXTS)


def _port(distance, num_dc_groups, num_groups, dc_code, ac_code):
    dc, ac = BitWriter(), BitWriter()
    S.write_dc_global(dc, compute_distance_params(distance), num_dc_groups, dc_code)
    S.write_ac_global(ac, num_groups, ac_code)
    return dc.to_section(), ac.to_section()


def _jax(distance, num_dc_groups, num_groups, dc_code, ac_code):
    def j(code):
        return JCode(context_map=code.context_map, depths=code.depths, bits=code.bits)

    dc, ac = JBitWriter(), JBitWriter()
    JS.write_dc_global(dc, j_distance_params(distance), num_dc_groups, j(dc_code))
    JS.write_ac_global(ac, num_groups, j(ac_code))
    return (dc.to_bytes(), dc.bits_written), (ac.to_bytes(), ac.bits_written)


@pytest.mark.parametrize("name, make, num_dc_groups, num_groups, distance", PARAMS)
def test_globals_equal_the_jax_package(name, make, num_dc_groups, num_groups, distance):
    dc_code, ac_code = _codes(make, seed=len(name))
    port = _port(distance, num_dc_groups, num_groups, dc_code, ac_code)
    want = _jax(distance, num_dc_groups, num_groups, dc_code, ac_code)
    for (raw, nbits), (want_bytes, want_bits) in zip(port, want):
        assert nbits == want_bits
        assert raw.tobytes() == want_bytes


def test_the_invariant_bits_are_built_once_a_num_dc_groups():
    static = load_static_codes()
    S.dc_global_invariant.cache_clear()
    timer = StageTimer()

    def builds(num_dc_groups, distance):
        with timer.collect():
            S.write_dc_global(BitWriter(), compute_distance_params(distance), num_dc_groups,
                              static.dc_codes[0])
        return timer.calls.get("assembly.globals.prefix", 0)

    got = [builds(g, d) for g, d in ((1, 1.0), (1, 1.0), (4, 1.0), (4, 1.0), (1, 2.0), (4, 0.5))]
    assert got == [1, 1, 2, 2, 2, 2]
    # Another distance meets the bits built before, behind its own quant
    # scales, and still writes the JAX package's bytes.
    for distance in (2.0, 0.5):
        with timer.collect():
            port = _port(distance, 4, 135, static.dc_codes[0], static.ac_codes[0])
        assert port[0][0].tobytes() == _jax(distance, 4, 135, static.dc_codes[0],
                                            static.ac_codes[0])[0][0]
    assert timer.calls["assembly.globals.prefix"] == 2


def test_bit_items_pack_as_a_bit_writer():
    rng = np.random.RandomState(5)
    items, writer = BitItems(), BitWriter()
    for _ in range(40):
        if rng.rand() < 0.5:
            nb = int(rng.randint(0, 57))
            v = int(rng.randint(0, 1 << min(nb, 62))) if nb else 0
            items.write(nb, v)
            writer.write(nb, v)
        else:
            nbs = rng.randint(0, 20, rng.randint(0, 6)).astype(np.uint8)
            vs = np.array([rng.randint(0, 1 << int(b)) if b else 0 for b in nbs], np.uint64)
            items.write_arrays(nbs, vs)
            writer.write_arrays(nbs, vs)
    packed = BitWriter()
    packed.write_arrays(*items.arrays())
    assert packed.bits_written == writer.bits_written
    assert packed.to_bytes() == writer.to_bytes()
    wide = BitItems()
    wide.write(3, 8)
    with pytest.raises(AssertionError):
        wide.arrays()
