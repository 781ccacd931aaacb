"""csrc/quantize.cu quantize_cells: reads each cell's 3 x 64 coefficients
(of the strategy's set) and its four per-cell maps, writes its 384 ordered
values and 3 x 4 counts (the count of chip_smoke.py and
tools/bench_aq_quantize.py, commit 8ebce9c)."""


def least_bytes(work):
    cells = work["groups"] * 1024
    return cells * (3 * 64 * 4 + 4 * 4 + 384 * 4 + 12 * 4)
