"""Ingest: the window's uploads a image whose float32 pixels were rounded
to float16 on the card, counted as the port's spans ingest.round
(transfer.upload_pixels); 0 where none ran, as on u8 uploads. Nothing
where the trace holds none of the port's spans (assembly.sections runs
once a job)."""
from jxlbench import program_spans as P


def read(run):
    if not run.images or not P.count(run, P.named("assembly.sections")):
        return None
    return P.count(run, P.named("ingest.round")) / run.images
