"""csrc/compact.cu copy_sections, launched by program B for the AC and the
DC sections: each section's block count and offset (16 bytes) read once,
each section word read once and written once; the words are the
codestreams' bytes (PERF.md section 6's rule, commit 8ebce9c)."""


def least_bytes(work):
    return (work["groups"] + work["dc_groups"]) * 16 + 2 * work["stream_bytes"]
