"""csrc/aq.cu aq_field: reads each group's XYB planes [3, 256, 256]
float32 and its 29 constants, writes three [32, 32] float32 fields (the
count chip_smoke.py and PERF.md section 6 use, copied at commit 8ebce9c)."""


def least_bytes(work):
    return work["groups"] * (3 * 256 * 256 * 4 + 3 * 1024 * 4) + work["images"] * 29 * 4
