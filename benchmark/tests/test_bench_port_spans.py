"""CPU checks of the readers of the port's own spans (jxlbench/
program_spans.py and the metrics that read them): on a synthetic trace,
the port's ranges nested inside the wrappers' ranges leave every reader
of the wrappers where it was; on a traced small cell, every reader of a
stage that runs on the CPU finds its span."""
import json
import os

import pytest

import helpers as H
from jxlbench import main, spans, spec, trace

NEW = ("ingest.convert_host_ms_per_mp", "programs.replay_host_ms_per_mp",
       "entropy.codes_host_ms_per_mp", "assembly.sections_host_ms_per_mp",
       "assembly.globals_host_ms_per_mp", "assembly.toc_host_ms_per_mp",
       "assembly.bytes_host_ms_per_mp", "program_b.ow_dc_growths_per_image")
CARD_ONLY = ("ingest.convert_host_ms_per_mp", "programs.replay_host_ms_per_mp")


def _program(name, t, kernels):
    """programs.run(name) at time t (us): the wrapper's range and inside it
    the port's copy-in, replay (a graph launch of `kernels`) and clone-out,
    each launching its device work."""
    return ("W", f"programs:{name}", t, t + 40, [
        ("P", f"programs:{name}.copy_in", t + 1, t + 5,
         [("L", t + 2, "Memcpy DtoD (Device -> Device)", "gpu_memcpy", t + 50, 2)]),
        ("P", f"programs:{name}.replay", t + 6, t + 30,
         [("L", t + 7, k, "kernel", t + 52 + 10 * i, 10) for i, k in enumerate(kernels)]),
        ("P", f"programs:{name}.clone_out", t + 31, t + 39,
         [("L", t + 32, "void at::native::elementwise_kernel<128, 2>(int)", "kernel",
           t + 52 + 10 * len(kernels), 3)]),
    ])


def _wait(t, dur=18):
    return ("W", "wait", t, t + dur, [("P", "transfer.wait", t + 1, t + dur - 1, [])])


def _request(t):
    """One 8 MP request as the encoder runs it: upload, program A, then
    result() around pack(), a second program B (ow_dc) and the assembly."""
    a = _program("analyze_batch_packed", t + 60,
                 ["void aq_kernel<8>(float const*)", "void strategy_kernel(float const*)",
                  "void quantize_kernel(float const*)", "void tokenize_kernel(int const*)"])
    b = ["void compact_rows_kernel<256>(int const*)", "void copy_sections_kernel<256>(int const*)"]
    return [
        ("W", "ingest", t, t + 50, [
            ("P", "ingest.pin", t + 1, t + 5, []),
            ("P", "ingest.convert", t + 5, t + 40, []),
            ("P", "ingest.copy", t + 40, t + 49,
             [("L", t + 45, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t + 55, 4)])]),
        a,
        ("W", "result", t + 105, t + 700, [
            ("W", "pack", t + 106, t + 330, [
                ("P", "codes.read", t + 107, t + 150, [_wait(t + 108, 40)]),
                ("P", "codes.build", t + 151, t + 250, []),
                ("P", "codes.upload", t + 251, t + 260,
                 [("L", t + 255, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t + 262, 1)]),
                _program("pack_batch_sections", t + 270, b)]),
            _wait(t + 331),
            ("P", "program_b.regrow:ow_dc", t + 350, t + 395,
             [_program("pack_batch_sections", t + 352, b)]),
            _wait(t + 400),
            ("P", "assembly.sections", t + 420, t + 470, [_wait(t + 425, 20)]),
            ("P", "assembly.globals", t + 471, t + 560, []),
            ("P", "assembly.toc", t + 561, t + 660, []),
            ("P", "assembly.bytes", t + 661, t + 690, []),
        ]),
    ]


def _synthetic(port, requests=3):
    """(Chrome events, the wrappers' spans) of `requests` requests; the
    port's ranges ("P") in the events only where `port`."""
    events = [dict(ph="X", cat="user_annotation", name="window", ts=0,
                   dur=1000 * requests, tid=1)]
    recorded, corr = [], [0]

    def walk(node, parent):
        if node[0] == "L":
            _, t, name, cat, dev_t, dur = node
            corr[0] += 1
            events.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=t,
                               dur=1, tid=1, args=dict(correlation=corr[0])))
            events.append(dict(ph="X", cat=cat, name=name, ts=dev_t, dur=dur, tid=7,
                               args=dict(correlation=corr[0])))
            return
        kind, name, s, e, kids = node
        if kind == "W":
            base, _, label = name.partition(":")
            recorded.append(spans.Span(base, label, s * 1e-6, e * 1e-6, parent))
            parent = len(recorded) - 1
        if kind == "W" or port:
            events.append(dict(ph="X", cat="user_annotation", name=name, ts=s, dur=e - s,
                               tid=1))
        for k in kids:
            walk(k, parent)

    for r in range(requests):
        for node in _request(1000 * r + 10):
            walk(node, -1)
    return events, recorded


def _run(port):
    events, recorded = _synthetic(port)
    work = dict(images=3, pixels=3 * 8294400, groups=3 * 135, dc_groups=3 * 4,
                pixel_bytes=3 * 3 * 8294400, stream_bytes=3 * 380000, tokens=3 * 2.5e6)
    stats = dict(replays=0)
    return main.Run(recorded, stats, dict(replays=9), trace.parse(events), work,
                    work["pixels"])


def _old_metrics():
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    return [n for n in names if n not in NEW]


def test_the_port_spans_leave_the_wrappers_metrics_as_they_were():
    """Each accepted per-layer metric reads the same with and without the
    port's ranges inside the wrappers' ranges: the program's device time
    goes by the prefix programs:<name>, which its spans keep."""
    old = _old_metrics()
    assert len(old) == 11
    bare, nested = _run(False), _run(True)
    assert len(nested.trace.ranges) > len(bare.trace.ranges)
    for name in old:
        reader = spec.load_module("metrics", name)
        want = reader.read(bare)
        assert want is not None, name
        assert reader.read(nested) == pytest.approx(want), name
    # The new readers find nothing in the bare trace, and in the nested one
    # each its stage: 35 us of ingest.convert a request, ...
    mp = bare.megapixels
    for name, us in (("ingest.convert_host_ms_per_mp", 35), ("programs.replay_host_ms_per_mp", 72),
                     ("entropy.codes_host_ms_per_mp", 99),
                     ("assembly.sections_host_ms_per_mp", 50 - 18),
                     ("assembly.globals_host_ms_per_mp", 89), ("assembly.toc_host_ms_per_mp", 99),
                     ("assembly.bytes_host_ms_per_mp", 29)):
        reader = spec.load_module("metrics", name)
        assert reader.read(bare) is None, name
        assert reader.read(nested) == pytest.approx(3 * us * 1e-3 / mp), name
    growths = spec.load_module("metrics", "program_b.ow_dc_growths_per_image")
    assert growths.read(bare) is None and growths.read(nested) == 1.0


def test_traced_small_cell_reads_the_port_spans():
    """A traced run of a small cell on the CPU: every new metric whose
    stage runs there reads a number (the upload and the graphs are the
    card's), and no B dispatch grew the DC budget."""
    r = H.run(H.small_cell("u8.single", per_layer=NEW + ("assembly.host_ms_per_mp",)),
              seed=2**31 + 17, trace=1)
    assert r["correct"], r["check"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW:
        if name in CARD_ONLY:
            assert name not in m, name
        else:
            assert m[name] >= 0, name
    assert m["program_b.ow_dc_growths_per_image"] == 0.0
    for name in NEW[2:7]:
        assert m[name] > 0, name
