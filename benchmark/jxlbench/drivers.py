"""The load generator, found by the name that the traffic mix gives
(`"loop"`: benchmark/loops/<name>.py), and the record of a window that
every loop returns.

A loop module defines
  run(enc, pool, traffic, distance, seconds, order, clock) -> Window
      one window of `seconds` of the mix through the encoder module
      `enc`'s entry points, `order` yielding pool indices;
  warm(enc, pool, traffic, distance)
      every shape and program key the window will use, before it.
A window starts at the first request and ends when the last request sent
before the deadline has returned, so every request sent counts, with all
of its time. A request that raises counts as failed.
"""
import dataclasses

from . import spec


@dataclasses.dataclass
class Request:
    idx: int  # pool index
    start: float
    end: float = None
    outputs: list = None  # one codestream per image
    error: str = None

    @property
    def ok(self):
        return self.error is None

    @property
    def latency(self):
        return self.end - self.start if self.ok else float("inf")


@dataclasses.dataclass
class Window:
    start: float
    end: float
    requests: list


def load(traffic, bench_dir=spec.BENCH_DIR):
    """The loop module the traffic mix names."""
    return spec.load_module("loops", traffic["loop"], bench_dir)
