"""Ingest: host milliseconds a megapixel inside the port's span
ingest.convert (transfer.upload_pixels on the card: the pixels converted
into the pinned buffer, f32 -> f16 or a u8 copy)."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.named("ingest.convert"))
