"""The seams where the benchmark's per-layer readers hook into the port
(benchmark/jxlbench/readers.py), on the CPU: each function the readers wrap
resolves to a callable of the port, and an encode runs its programs through
ops.programs.run under the labels the readers look for. A reader that
finds neither reads None rather than raising, so a rename would blank its
metrics without failing a run."""
import os
import sys

import pytest

from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import programs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from jxlbench import readers  # noqa: E402
from jxlbench import spans as S  # noqa: E402


def _spec(seam):
    (spec,) = getattr(readers, seam).values()
    return {"target": spec} if isinstance(spec, str) else spec


@pytest.mark.parametrize("seam", ["INGEST", "PROGRAMS", "WAIT", "PACK", "RESULT"])
def test_benchmark_seams_resolve(seam):
    target = _spec(seam)["target"]
    assert target.startswith("jxl_tiny_tpu_torch."), target
    owner, attr = S._resolve(target)
    assert callable(getattr(owner, attr)), target


def test_encode_runs_the_programs_the_readers_name(monkeypatch):
    label_arg = _spec("PROGRAMS")["label_arg"]
    run, labels = programs.run, []

    def spy(*args, **kwargs):
        labels.append(args[label_arg])
        return run(*args, **kwargs)

    monkeypatch.setattr(programs, "run", spy)
    img = read_pfm(os.path.join(REPO, "testdata", "tiny64.pfm"))
    assert TE.encode_image_device(img, 1.0, device="cpu")
    assert labels[0] == readers.PROGRAM_A
    assert set(labels) == {readers.PROGRAM_A, readers.PROGRAM_B}
