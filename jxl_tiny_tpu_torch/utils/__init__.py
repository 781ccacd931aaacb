"""Observability (profiling.py) and debug mode (debug.py) of the port."""
from .debug import debug_mode  # noqa: F401
from .profiling import StageTimer, busy_share, device_time, encode_report, profile_trace  # noqa: F401
