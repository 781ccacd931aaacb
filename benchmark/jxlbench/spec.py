"""What a run runs, found by name: the cell in BENCHMARK.json, its
configuration (configs/<config>.json) and the generator of inputs that it
names (generators/<generator>.py), its traffic mix
(traffic/<traffic>.json) and the load generator that it names
(loops/<loop>.py), the limits its check holds the output to
(limits/<cell>.json), the readers of its per-layer metrics
(metrics/<metric>.py) and the byte counts of the kernels
(roofline/<kernel>.py). Adding a cell, a configuration, a mix, a
generator, a loop or a metric is adding files and entries; nothing here
names one."""
import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: str = BENCH_DIR  # where its generator, loop and readers lie


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, name, bench_dir=BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files under
    bench_dir; raises KeyError for a cell it does not list and OSError for
    a file that is missing."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in spec["workloads"]}[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(root, configs[work["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", work["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", name + ".json"))
    return Cell(name, work["chips"], config, traffic, limits,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], bench_dir)


def load_module(kind, name, bench_dir=BENCH_DIR):
    """benchmark/<kind>/<name>.py as a module (its name may hold dots)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    mod_name = f"jxlbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_modules(bench_dir=BENCH_DIR) -> dict:
    """{kernel name: module} of every roofline/<kernel>.py."""
    folder = os.path.join(bench_dir, "roofline")
    return {f[:-3]: load_module("roofline", f[:-3], bench_dir)
            for f in sorted(os.listdir(folder)) if f.endswith(".py")}
