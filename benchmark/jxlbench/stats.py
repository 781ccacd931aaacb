"""The arithmetic of the metrics: every rate is all the work over all the
time of the window, a tail is over every request (a failed one counts as
missing any limit), and the device's busy time is the union of its
intervals across streams."""
import math


def rate(megapixels, seconds) -> float:
    """Megapixels per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window has a length")
    return megapixels / seconds


def percentile(values, q) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values; a
    failed request is +inf, so it lands in the tail."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def bits_per_pixel(nbytes, pixels) -> float:
    return 8.0 * nbytes / pixels


def union(intervals):
    """Sorted, disjoint [start, end) intervals covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo, hi) -> float:
    """Time within [lo, hi) covered by at least one interval."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi): where no interval runs."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
