"""csrc/compact.cu compact_rows, launched by program A on the token rows
and by program B on the AC and DC section word rows: each row's count and
start (12 bytes) read once, each token or word placed read once and written
once. The tokens are the golden model's count; the section words are the
codestreams' bytes (PERF.md section 6's rule, commit 8ebce9c)."""


def least_bytes(work):
    a = work["groups"] * 3 * 1024 * 12 + 2 * 4 * work["tokens"]
    b = (work["groups"] + work["dc_groups"]) * 12 + 2 * work["stream_bytes"]
    return a + b
