"""A closed loop with one client, driving the encoder's public entry point
that the traffic mix names (`"entry"`):

  single   encode_image_device(image): the next call when the last returns
  batch    encode_batch_device(images): one call a request, back to back
  stream   encode_images_device(images, depth=...): one call over an
           endless iterator; images are pulled until the deadline, and
           those in flight then drain (a window ends at the last image
           yielded; a stream that raises fails every image not yet yielded)
"""
import time

from jxlbench.drivers import Request, Window


def _entry(enc, traffic, distance):
    kind = traffic["entry"]
    if kind == "single":
        return lambda req: [enc.encode_image_device(req[0], distance)]
    if kind == "batch":
        return lambda req: enc.encode_batch_device(req, distance)
    raise ValueError(f"unknown entry {kind}")


def run(enc, pool, traffic, distance, seconds, order, clock=time.perf_counter) -> Window:
    """One window of `seconds` of this traffic on the pool; `order` yields
    pool indices."""
    if traffic.get("clients", 1) != 1:
        raise ValueError("a closed loop drives one client")
    if traffic["entry"] == "stream":
        return _stream(enc, pool, traffic, distance, seconds, order, clock)
    call = _entry(enc, traffic, distance)
    t0 = clock()
    deadline = t0 + seconds
    reqs = []
    while not reqs or clock() < deadline:
        idx = next(order)
        r = Request(idx, clock())
        try:
            r.outputs = call(pool.requests[idx])
        except Exception as e:  # the request failed; the run goes on
            r.error = f"{type(e).__name__}: {e}"
        r.end = clock()
        reqs.append(r)
    return Window(t0, reqs[-1].end, reqs)


def _stream(enc, pool, traffic, distance, seconds, order, clock):
    t0 = clock()
    deadline = t0 + seconds
    reqs = []

    def images():
        while not reqs or clock() < deadline:
            idx = next(order)
            reqs.append(Request(idx, clock()))
            yield pool.requests[idx][0]

    done = 0
    try:
        for data in enc.encode_images_device(images(), distance, depth=traffic["depth"]):
            reqs[done].outputs, reqs[done].end = [data], clock()
            done += 1
    except Exception as e:  # the stream ended; what it did not yield failed
        for r in reqs[done:]:
            r.error, r.end = f"{type(e).__name__}: {e}", clock()
    return Window(t0, max(r.end for r in reqs), reqs)


def warm(enc, pool, traffic, distance):
    """Every request of the pool twice, as the window sends them: the first
    call of each of the programs' keys runs eagerly, the second captures
    it, so the window only replays."""
    order = iter(list(range(len(pool.requests))) * 2)
    if traffic["entry"] == "stream":
        imgs = (pool.requests[i][0] for i in order)
        for _ in enc.encode_images_device(imgs, distance, depth=traffic["depth"]):
            pass
        return
    call = _entry(enc, traffic, distance)
    for i in order:
        call(pool.requests[i])
