from .decoder import decode_jxl  # noqa: F401
