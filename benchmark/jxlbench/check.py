"""Whether the codestreams the timed path returned are right: each sampled
codestream is parsed back into what it encodes (reference/parse.py), and
every group of it is held against the golden model (reference/golden.py)
run on the same pixels.

The comparison is of integers: the frame header's and DC global's
quantizer scales and loop filters, each block's transform, first-cell flag and
quant field, each 64x64 tile's colour-correlation factors, and every
quantized DC and AC value. The port and the golden model are both float32
programs and part ways at float ties: a number within a hair of a
rounding boundary rounds either way, and a decision made from near-equal
costs goes either way. So two numbers are compared: the values that
differ where the golden model's number was not at a tie (nor a number it
is computed from), which must be none, and the blocks whose decisions
differ, per million, whose limit is set from sound runs and from the
lower-precision control (PERF.md). A codestream that does not parse, or
has another size than its image, fails outright.

The control puts the golden model on lower-precision data in the
program's place (`Checker.control`): the same numbers, read against the
golden model at full precision.

The work runs on the host in a pool of processes after the window: the DC
groups first (the AC groups need their maps), then each group's golden
model and its AC section together.
"""
import multiprocessing
import os

import numpy as np

from .reference import constants as C
from .reference import golden
from .reference import parse
from .reference.common import clamp_distance, compute_distance_params
from .reference.errors import DecodeError


def _ac_mask():
    """[3, 128] bool: the positions that carry AC tokens, by strategy."""
    m = np.zeros((3, 128), bool)
    m[C.DCT8, C.COEFF_ORDER8[1:]] = True
    m[C.DCT16X8, C.COEFF_ORDER16[2:]] = True
    m[C.DCT8X16, C.COEFF_ORDER16[2:]] = True
    return m


def round_mantissa(x, bits, min_exp, max_value):
    """x rounded to nearest (ties to even) with `bits` stored mantissa bits,
    exponents below min_exp as subnormals, saturated at max_value: bf16 is
    (7, -126, 3.39e38)."""
    x = np.asarray(x, np.float64)
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-300)))
    step = np.exp2(np.maximum(e, min_exp) - bits)
    return np.clip(np.rint(x / step) * step, -max_value, max_value).astype(np.float32)


PRECISIONS = {
    "bfloat16": dict(bits=7, min_exp=-126, max_value=3.3895e38),
}


def differences(dec, quantized, ref) -> dict:
    """Counts of what differs between decisions `dec` (strategy, is_first,
    raw_qf [yb, xb]; ytox, ytob; quant_dc [3, yb, xb]) with their AC values
    `quantized` [3, yb, xb, 128] and the golden model's `ref`.

    blocks_off: blocks whose transform, first-cell flag or quant field
    differs, or whose 64x64 tile's colour factors do; their values are
    not compared. values_off: values that differ elsewhere, other than at
    the golden model's ties (ref's tie_ac, tie_dc)."""
    yb, xb = ref["strategy"].shape
    out = dict(blocks=yb * xb, tokens=ref["tokens"])
    tile_off = (dec["ytox"] != ref["ytox"]) | (dec["ytob"] != ref["ytob"])
    off = ((dec["strategy"] != ref["strategy"]) | (dec["is_first"] != ref["is_first"])
           | (dec["raw_qf"] != ref["raw_qf"])
           | tile_off.repeat(8, 0).repeat(8, 1)[:yb, :xb])
    out["blocks_off"] = int(off.sum())
    same = ~off
    # Each first cell's AC positions, by the golden model's strategy.
    mask = _ac_mask()[ref["strategy"].astype(np.int64)] & (ref["is_first"] & same)[..., None]
    mask = np.broadcast_to(mask, quantized.shape)
    ac_diff = (quantized != ref["quantized"]) & mask
    dc_diff = (dec["quant_dc"] != ref["quant_dc"]) & same
    out["values"] = int(mask.sum()) + int(same.sum()) * 3
    out["at_ties"] = int((ac_diff & ref["tie_ac"]).sum() + (dc_diff & ref["tie_dc"]).sum())
    out["values_off"] = int((ac_diff & ~ref["tie_ac"]).sum() + (dc_diff & ~ref["tie_dc"]).sum())
    out["groups_off"] = int(bool(out["blocks_off"] or out["values_off"] or out["at_ties"]))
    return out


def header_off(front, distance) -> int:
    """How many of the header's fields differ from what the reference
    encoder writes at this distance: the quantizer scales (enc_frame.cc:
    115-156, 459-485) and the loop filter (enc_frame.cc:426-457: the
    all-default filter, gaborish on and 2 EPF iterations, where EPF runs
    twice; otherwise gaborish off and the EPF count)."""
    distp = compute_distance_params(clamp_distance(distance))
    want = dict(x_qm_scale=distp.x_qm_scale, global_scale=distp.global_scale,
                quant_dc_param=distp.quant_dc, epf_iters=distp.epf_iters,
                gaborish=distp.epf_iters == 2)
    return sum(int(getattr(front, k) != v) for k, v in want.items())


def _group_task(args):
    """One group: the golden model on its patch against the parse of its AC
    section with the DC groups' decisions (dec)."""
    patch, yb, xb, distance, ac_codes, section, dec = args
    distp = compute_distance_params(clamp_distance(distance))
    ref = golden.analyze_group(patch, yb, xb, distp)
    try:
        got = parse.parse_ac_group(ac_codes, section, dec["strategy"], dec["is_first"])
    except DecodeError as e:
        return dict(error=f"AC section: {e}")
    return differences(dec, got[:, :yb, :xb], ref)


def _control_task(args):
    """One group: the golden model on lower-precision data against the
    golden model on the patch."""
    patch, yb, xb, distance, precision = args
    distp = compute_distance_params(clamp_distance(distance))
    ref = golden.analyze_group(patch, yb, xb, distp)
    low = golden.analyze_group(patch, yb, xb, distp,
                               round_fn=lambda a: round_mantissa(a, **PRECISIONS[precision]))
    return differences(low, low["quantized"], ref)


def _dc_task(args):
    front, idx = args
    try:
        return parse.parse_dc_group(front, idx)
    except DecodeError as e:
        return f"DC group {idx}: {e}"


def add_counts(total, out):
    for k, v in out.items():
        total[k] = total.get(k, 0) + v


class Checker:
    """A pool of host processes that compares codestreams with the golden
    model. Use as a context manager: the pool ends with the block."""

    def __init__(self, workers=None):
        self.workers = workers or min(8, os.cpu_count() or 1)
        self._pool = None

    def __enter__(self):
        ctx = multiprocessing.get_context("spawn")
        self._pool = ctx.Pool(self.workers)
        return self

    def __exit__(self, *exc):
        self._pool.close()
        self._pool.join()
        self._pool = None

    @staticmethod
    def _groups(pixels):
        _, h, w = pixels.shape
        for gy in range(-(-h // 256)):
            for gx in range(-(-w // 256)):
                yield gy, gx, min(32, -(-h // 8) - gy * 32), min(32, -(-w // 8) - gx * 32)

    def compare(self, data: bytes, pixels: np.ndarray, distance: float) -> dict:
        """One codestream against the golden model on `pixels`, the [3, H, W]
        float32 linear image as the configuration says the encoder sees it.
        Returns the summed counts, header_off among them, or {"error": ...}
        where it does not parse."""
        try:
            front = parse.parse_front(data)
        except DecodeError as e:
            return dict(error=f"front: {e}")
        _, h, w = pixels.shape
        dim = front.dim
        if (dim.xsize, dim.ysize) != (w, h):
            return dict(error=f"size {dim.xsize}x{dim.ysize}, image {w}x{h}")
        parts = self._pool.map(_dc_task, [(front, i) for i in range(dim.num_dc_groups)])
        bad = [p for p in parts if isinstance(p, str)]
        if bad:
            return dict(error=bad[0])
        maps = parse.merge_dc(front, parts)
        tasks = []
        for gy, gx, yb, xb in self._groups(pixels):
            by, bx, ty0, tx0 = gy * 32, gx * 32, gy * 4, gx * 4
            ty, tx = -(-yb // 8), -(-xb // 8)
            dec = dict(strategy=maps.strategy[by: by + yb, bx: bx + xb],
                       is_first=maps.is_first[by: by + yb, bx: bx + xb],
                       raw_qf=maps.raw_qf[by: by + yb, bx: bx + xb],
                       quant_dc=maps.quant_dc[:, by: by + yb, bx: bx + xb],
                       ytox=maps.ytox[ty0: ty0 + ty, tx0: tx0 + tx],
                       ytob=maps.ytob[ty0: ty0 + ty, tx0: tx0 + tx])
            tasks.append((golden.extract_group(pixels, gx, gy), yb, xb, distance,
                          front.ac_codes, front.ac_sections[gy * dim.xsize_groups + gx], dec))
        out = self._sum(_group_task, tasks)
        if "error" not in out:
            out["header_off"] = header_off(front, distance)
        return out

    def control(self, pixels: np.ndarray, distance: float, precision: str) -> dict:
        """The golden model on `pixels` with its data in `precision`
        (PRECISIONS) in the program's place: the same counts as compare."""
        tasks = [(golden.extract_group(pixels, gx, gy), yb, xb, distance, precision)
                 for gy, gx, yb, xb in self._groups(pixels)]
        return self._sum(_control_task, tasks)

    def _sum(self, fn, tasks):
        total = {}
        for out in self._pool.imap_unordered(fn, tasks, chunksize=1):
            if "error" in out:
                return dict(error=out["error"])
            add_counts(total, out)
        total["groups"] = len(tasks)
        return total


def summarize(total) -> dict:
    """The numbers compared, from summed counts: values that differ away
    from a tie (an exact count), and blocks whose decisions differ per
    million blocks."""
    return dict(values_off=total.get("values_off", 0),
                blocks_off_ppm=1e6 * total.get("blocks_off", 0) / max(total.get("blocks", 0), 1))
