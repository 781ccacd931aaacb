"""csrc/tokenize.cu tokenize_rows: one row a cell and channel (3 x 1,024 a
group); reads its 128 values and writes its 128 token words, with one meta
word a row (the count of chip_smoke.py, commit 8ebce9c)."""


def least_bytes(work):
    rows = work["groups"] * 3 * 1024
    return rows * (128 * 4 * 2 + 4)
