"""csrc/strategy.cu estimate_partials: reads a group's three coefficient
sets (8x8, 16x8, 8x16: 3 x 65,536 floats each), its quant field, masking
and colour factors at the three transform shapes (8,192 floats) and the
quant matrices (576 floats an image), writes 6 x 2,048 float partials
(the count of chip_smoke.py and tools/bench_strategy_bitpack.py, commit
8ebce9c)."""


def least_bytes(work):
    per_group = (3 * 3 * 65536 + 8192) * 4 + 6 * 2048 * 4
    return work["groups"] * per_group + work["images"] * (192 + 384) * 4
