"""Numpy golden model: the specification of each stage of the encode
(dct_np: the scaled DCTs; pipeline_np: XYB, the AQ field, CfL and the
AC-strategy search; group_np: quantization and the token arrays of one
group). The device pipeline (ops/) and the verification decoder (decode/)
are checked against it; it is not a device path."""
