"""Helpers the per-layer metrics' readers share (benchmark/metrics/*.py)."""
from . import spans as S
from . import trace as T

# The spans the readers wrap around the program, where the encoder looks
# each function up.
INGEST = {"ingest": "jxl_tiny_tpu_torch.encoder:upload_pixels"}
PROGRAMS = {"programs": {"target": "jxl_tiny_tpu_torch.ops.programs:run", "label_arg": 0}}
WAIT = {"wait": "jxl_tiny_tpu_torch.transfer:Fetch.numpy"}
PACK = {"pack": "jxl_tiny_tpu_torch.encoder:DeviceEncodeJob.pack"}
RESULT = {"result": "jxl_tiny_tpu_torch.encoder:DeviceEncodeJob.result"}

PROGRAM_A = "analyze_batch_packed"
PROGRAM_B = "pack_batch_sections"


def per_mp_ms(run, seconds):
    return seconds * 1e3 / run.megapixels if run.megapixels else None


def program_device_seconds(run, program):
    """Device time of the operations launched inside programs.run(program)
    in the traced window, from the trace alone; None where it holds none."""
    t = T.device_seconds(run.trace.in_window(), f"programs:{program}")
    return t if t > 0 else None


def kernel_seconds(run):
    """{kernel name: device seconds} of the traced window's kernels."""
    out = {}
    lo, hi = run.trace.window
    for o in run.trace.in_window():
        k = T.kernel_name(o.name)
        out[k] = out.get(k, 0.0) + (min(o.end, hi) - max(o.start, lo))
    return out


total, exclusive, count = S.total, S.exclusive, S.count
