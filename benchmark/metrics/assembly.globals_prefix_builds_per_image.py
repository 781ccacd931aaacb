"""Assembly: the window's builds of the DC global's frame-invariant bits
a image, counted as the port's spans assembly.globals.prefix
(bitstream/sections.dc_global_invariant opens one only where it builds
those bits: once a frame geometry, in the warm-up). 0 where every image
met bits built before; above 0, the geometry changed inside the window.
Nothing where the trace holds none of the port's spans (assembly.sections
runs once a job), nor from a program that builds those bits for every
image (no sections.dc_global_invariant)."""
from jxlbench import program_spans as P


def read(run):
    if not run.images or not P.count(run, P.named("assembly.sections")):
        return None
    from jxl_tiny_tpu_torch.bitstream import sections

    if not hasattr(sections, "dc_global_invariant"):
        return None
    return P.count(run, P.named("assembly.globals.prefix")) / run.images
