"""Assembly: host milliseconds a megapixel inside the port's span
assembly.sections (DeviceEncodeJob._fetch_sections: program B's section
words read and turned into one BitWriter a section) less its waits for
the card (transfer.wait)."""
from jxlbench import program_spans as P


def read(run):
    return P.ms_per_mp(run, P.named("assembly.sections"), P.named("transfer.wait"))
