"""The collectives of one image's encode over a mesh of n ranks
(parallel/sharding.Mesh; the default two-pass tier, the "gather" route of
the DC layout), from the image's geometry alone: each collective's calls
and the bytes one rank sends and receives in them, counted as
Mesh.stats() counts them (the least any algorithm moves: all_reduce
2(n-1)/n of the buffer each way, all_gather (n-1) parts each way, the
gather to rank 0 one part a rank).

A rank holds gps = ceil(G/n) groups and gd_ps = ceil(Gd/n) DC groups.
Program A all-gathers the per-group maps for the DC layout (6,176 int32 a
group: quant_dc 3x32x32, raw_qf, strategy and is_first 32x32, ytox and
ytob 4x4) and the token totals (gps int64), and sums the AC and DC base-64
histograms (2x64x64 int64); program B all-gathers the section sizes (AC
and DC bits and word offsets, 2 gps + 2 gd_ps int64), once a dispatch;
the result gathers every rank's AC and DC section words (int32) to rank 0
as one part a rank.
"""
MAP_BYTES = 6176 * 4
HIST_BYTES = 2 * 64 * 64 * 8
QUANTUM = 65536  # words: the section read's download granule
OW = 8192  # words: program B's first word budget a section
LINK_BYTES_PER_S = 450e9  # H100 SXM, NVLink 4: 900 GB/s both ways, per direction


def _ceil(a, b):
    return -(-a // b)


def wcap(sections):
    """Words of one rank's compacted section buffer at the first word
    budget (ops/pack_kernels.sections_wcap)."""
    return min(1 << int(sections * OW).bit_length(), 2 * 1024 * 1024)


def counts(groups, dc_groups, ranks, rank=0, part_words=None):
    """{collective: dict(calls, sent, received)} of one image's encode on
    `rank` of `ranks`, program B dispatched once. part_words: int32 words
    in each rank's part of the gather to rank 0; None for the part the
    read takes where each rank's sections of each kind fit in one QUANTUM
    (its wcap, at most QUANTUM, a kind)."""
    n = ranks
    gps, gd_ps = _ceil(groups, n), _ceil(dc_groups, n)
    if part_words is None:
        part_words = min(wcap(gps), QUANTUM) + min(wcap(gd_ps), QUANTUM)
    gathered = (n - 1) * (gps * MAP_BYTES + gps * 8 + (2 * gps + 2 * gd_ps) * 8)
    summed = 2 * (n - 1) * HIST_BYTES // n
    part = 4 * part_words
    return dict(
        all_gather=dict(calls=3, sent=gathered, received=gathered),
        psum=dict(calls=1, sent=summed, received=summed),
        gather0=dict(calls=1, sent=0 if rank == 0 else part,
                     received=(n - 1) * part if rank == 0 else 0),
    )


def least_bytes(work, ranks):
    """The bytes rank 0's links must carry in the window, the busier
    direction of each collective: every image's collectives, its part of
    the gather the even share of its codestream's bytes (no download
    granule)."""
    if not work["images"] or ranks is None:
        return None
    n_img = work["images"]
    c = counts(work["groups"] // n_img, work["dc_groups"] // n_img, ranks,
               part_words=work["stream_bytes"] / n_img / 4 / ranks)
    return n_img * sum(max(v["sent"], v["received"]) for v in c.values())
