"""CPU checks of assembly.globals_prefix_builds_per_image (benchmark/
metrics): on the synthetic trace of three 8 MP requests that
test_bench_port_spans builds, nothing without the port's spans, 0.0 with
them and no assembly.globals.prefix, 1.0 with one inside each request's
assembly.globals, and nothing from a program without the hoist; on a
traced small cell on the CPU, whose one geometry the warm-up built, 0.0."""
import pytest

import helpers as H
import test_bench_port_spans as PS
from jxlbench import main, spec, trace

READER = spec.load_module("metrics", "assembly.globals_prefix_builds_per_image")


def _run(port, builds):
    events, recorded = PS._synthetic(port)
    for r in range(builds):
        t = 1000 * r + 10
        events.append(dict(ph="X", cat="user_annotation", name="assembly.globals.prefix",
                           ts=t + 475, dur=20, tid=1))
    work = dict(images=3, pixels=3 * 8294400, groups=3 * 135, dc_groups=3 * 4,
                pixel_bytes=3 * 3 * 8294400, stream_bytes=3 * 380000, tokens=3 * 2.5e6)
    return main.Run(recorded, dict(replays=0), dict(replays=9), trace.parse(events), work,
                    work["pixels"])


@pytest.mark.parametrize("port,builds,want", [(False, 0, None), (True, 0, 0.0), (True, 3, 1.0),
                                              (True, 1, 1 / 3)])
def test_prefix_builds_on_a_made_up_trace(port, builds, want):
    got = READER.read(_run(port, builds))
    assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_the_hoist_reads_nothing(monkeypatch):
    from jxl_tiny_tpu_torch.bitstream import sections

    monkeypatch.delattr(sections, "dc_global_invariant")
    assert READER.read(_run(True, 0)) is None


def test_traced_small_cell_builds_no_prefix_in_its_window():
    name = "assembly.globals_prefix_builds_per_image"
    r = H.run(H.small_cell("u8.single", per_layer=(name,)), seed=2**31 + 23, trace=1)
    assert r["correct"], r["check"]
    assert r["metrics"][name]["value"] == 0.0
