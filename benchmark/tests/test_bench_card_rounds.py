"""CPU checks of ingest.card_rounds_per_image (benchmark/metrics): on the
synthetic trace of three 8 MP requests that test_bench_port_spans builds,
nothing without the port's spans, 0.0 with them and no ingest.round, 1.0
with one inside each request's ingest.copy; on a traced small cell on
the CPU (u8 pixels, and no card to round on), 0.0."""
import pytest

import helpers as H
import test_bench_port_spans as PS
from jxlbench import main, spec, trace

READER = spec.load_module("metrics", "ingest.card_rounds_per_image")


def _run(port, rounds):
    events, recorded = PS._synthetic(port)
    for r in range(rounds):
        t = 1000 * r + 10
        events.append(dict(ph="X", cat="user_annotation", name="ingest.round", ts=t + 46,
                           dur=2, tid=1))
    work = dict(images=3, pixels=3 * 8294400, groups=3 * 135, dc_groups=3 * 4,
                pixel_bytes=3 * 3 * 8294400, stream_bytes=3 * 380000, tokens=3 * 2.5e6)
    return main.Run(recorded, dict(replays=0), dict(replays=9), trace.parse(events), work,
                    work["pixels"])


@pytest.mark.parametrize("port,rounds,want", [(False, 0, None), (True, 0, 0.0), (True, 3, 1.0),
                                              (True, 1, 1 / 3)])
def test_card_rounds_on_a_made_up_trace(port, rounds, want):
    got = READER.read(_run(port, rounds))
    assert got == (None if want is None else pytest.approx(want))


def test_traced_small_cell_rounds_nothing_on_the_cpu():
    name = "ingest.card_rounds_per_image"
    r = H.run(H.small_cell("u8.single", per_layer=(name,)), seed=2**31 + 21, trace=1)
    assert r["correct"], r["check"]
    assert r["metrics"][name]["value"] == 0.0
