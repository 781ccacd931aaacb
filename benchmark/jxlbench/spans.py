"""Host-clock spans around the program's functions, recorded from outside.

The program has no spans of its own, so a traced run wraps the functions
that the per-layer metrics name, where the encoder looks them up
(`module:attribute`, or `module:Class.method`). Each call becomes a span:
its name, a label (the call's first argument where the metric asks, such
as the program's name for `programs.run`), its start and end on the host
clock, and its parent, the span open on the same thread when it began. A
span is also a `torch.profiler.record_function` range, so that the trace
can tell which host span launched each kernel. Nothing inside the program changes;
`uninstall` puts every function back.
"""
import dataclasses
import importlib
import threading
import time


@dataclasses.dataclass
class Span:
    name: str
    label: str
    start: float
    end: float
    parent: int  # index into the record list, -1 at the top


def _resolve(target):
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Recorder:
    """The spans and the wrapped functions of one traced run."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.spans = []
        self.active = False
        self._local = threading.local()
        self._patched = []

    def install(self, specs):
        """specs: {span name: target or {"target", "label_arg"}}."""
        for name, spec in specs.items():
            if isinstance(spec, str):
                spec = {"target": spec}
            owner, attr = _resolve(spec["target"])
            original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            setattr(owner, attr, self._wrap(original, name, spec.get("label_arg")))
            self._patched.append((owner, attr, original))

    def uninstall(self):
        for owner, attr, original in reversed(self._patched):
            setattr(owner, attr, original)
        self._patched.clear()

    def _wrap(self, fn, name, label_arg):
        import torch

        rec = self

        def wrapper(*args, **kwargs):
            if not rec.active:
                return fn(*args, **kwargs)
            label = str(args[label_arg]) if label_arg is not None else ""
            stack = rec._stack()
            idx = len(rec.spans)
            span = Span(name, label, rec.clock(), None, stack[-1] if stack else -1)
            rec.spans.append(span)
            stack.append(idx)
            try:
                with torch.profiler.record_function(f"{name}:{label}" if label else name):
                    return fn(*args, **kwargs)
            finally:
                stack.pop()
                span.end = rec.clock()

        return wrapper

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack


# -- what the readers compute from the spans ---------------------------------

def _children(spans):
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    return kids


def total(spans, name, label=None) -> float:
    """Seconds inside spans of this name (and label), outermost ones only."""
    out = 0.0
    for s in spans:
        if s.name == name and (label is None or s.label == label) and not _inside(spans, s, name):
            out += s.end - s.start
    return out


def _inside(spans, s, name):
    p = s.parent
    while p >= 0:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def exclusive(spans, name, minus) -> float:
    """Seconds inside spans `name`, less the time that spans named in
    `minus` under them cover (each such span counted at its outermost)."""
    kids = _children(spans)
    out = 0.0
    for i, s in enumerate(spans):
        if s.name != name or _inside(spans, s, name):
            continue
        covered, todo = [], list(kids[i])
        while todo:
            k = todo.pop()
            if spans[k].name in minus:
                covered.append((spans[k].start, spans[k].end))
            else:
                todo.extend(kids[k])
        from .stats import busy

        out += (s.end - s.start) - busy(covered, s.start, s.end)
    return out


def count(spans, name, label=None) -> int:
    return sum(1 for s in spans if s.name == name and (label is None or s.label == label))
