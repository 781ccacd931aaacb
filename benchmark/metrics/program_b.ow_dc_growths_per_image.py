"""Program B: its re-dispatches a window's image that the DC sections'
word budget (ow_dc) caused, counted as the port's spans
program_b.regrow:ow_dc; 0 where none ran. The count of every rule and of
program A's cap retries goes to standard error. Nothing where the trace
holds none of the port's spans (assembly.sections runs once a job)."""
import sys

from jxlbench import program_spans as P

RULES = ("ow", "ow_dc", "compact_ac", "compact_dc")


def read(run):
    if not run.images or not P.count(run, P.named("assembly.sections")):
        return None
    counts = {f"program_b.regrow:{r}": P.count(run, P.named(f"program_b.regrow:{r}"))
              for r in RULES}
    counts["program_a.cap_retry"] = P.count(run, P.named("program_a.cap_retry"))
    for name, n in counts.items():
        print(f"retries {name}: {n} ({n / run.images:.4f} an image, {run.images} images)",
              file=sys.stderr)
    return counts["program_b.regrow:ow_dc"] / run.images
