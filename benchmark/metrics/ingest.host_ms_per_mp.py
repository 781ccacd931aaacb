"""Ingest: host milliseconds a megapixel inside transfer.upload_pixels (the
conversion into the pinned buffer and the queued copy), host clock."""
from jxlbench import readers as R

SPANS = R.INGEST


def read(run):
    if not R.count(run.spans, "ingest"):
        return None
    return R.per_mp_ms(run, R.total(run.spans, "ingest"))
