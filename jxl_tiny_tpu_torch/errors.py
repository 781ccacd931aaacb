"""Typed error hierarchy — the host-side role of the reference's Status
bool-wrapper and JXL_FAILURE macros (base/status.h:145-244). Device-side
code never aborts (invalid lanes are masked); failures surface at the host
boundary as these exceptions."""


class JxlTinyError(Exception):
    """Base class for encoder errors."""


class InvalidInputError(JxlTinyError):
    """Bad user input: malformed PFM, invalid distance, wrong shape."""


class DecodeError(JxlTinyError):
    """Malformed or truncated codestream (verification decoder, decode/).
    Every defect a bitstream mutation can introduce surfaces as this type:
    over-reads, nonzero padding, wrong section sizes, bad field values."""
