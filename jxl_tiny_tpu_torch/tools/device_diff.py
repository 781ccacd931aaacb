"""Locate where program A on the card departs from program A on the host's
CPU, for one upload.

    python -m jxl_tiny_tpu_torch.tools.device_diff [IMAGE] [--upload u8|f16|f32]

IMAGE defaults to testdata/photo8mp.pfm; --upload (default u8) is the
array a user hands the encoder: u8 sRGB (io/color.linear_to_srgb_u8),
float16 or float32 linear; the distance is 1.0. The CPU runs program A's stages
(ops/pipeline, the plain versions) once; then the card runs each stage on
the CPU's inputs of that stage, so that each stage's difference is its own:

  extract_groups, to_xyb, aq_field (the kernel against its plain version
  on the CPU), aq_tail (float32 log2 / exp2: qf, and the raw_qf decision),
  dct2d_8x8, compute_cmap (ytox / ytob decisions), strategy_estimates (the
  cost maps e8 / ev / eh and the 16x8 / 8x16 coefficient sets), the
  strategy decisions, adjust_quant_field, the quantizer (quant_dc and the
  quantized AC values) and the token stream words and totals.

A stage's line gives the share of values that differ, the groups they lie
in and the first differing element with both values. For a decision
(raw_qf, ytox / ytob, strategy, quant_dc, AC value), each differing element
gets its distance from the boundary of the CPU's own unrounded input: the
rounding boundary (or the AC zero threshold) for a rounded value; for a
strategy quad, the relative gap of the closest pair of costs compared and
the distance of the quad's nearest estimate value from its rounding
boundary (tests/test_torch_neartie.py's rules: costs within rtol RTOL, a
value within TIE). A differing decision farther than that is reported as
NOT AT A TIE, and the command exits 1. Last, the whole program A and the
whole encode run once on each device: the groups whose stream, totals,
maps or DC layout differ, and both codestreams' sizes and sha256.

Needs a CUDA card (it raises without one); everything is computed in this
run, nothing is read from earlier ones.
"""
import argparse
import hashlib
import os
import sys
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from .. import constants as C
from .. import encoder as TE
from ..common import compute_distance_params
from ..io.color import linear_to_srgb_u8
from ..io.pfm import read_pfm
from ..ops import aq_kernel as AQ
from ..ops import pipeline as PL
from ..ops import quantize_kernel as QK
from ..ops import strategy_kernel as SK
from ..ops.dct import dct2d_8x8
from ..tables import device_tables
from ..transfer import resolve_device

PHOTO8MP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                        "testdata", "photo8mp.pfm")
DISTANCE = 1.0
TIE = 1e-4  # distance of an unrounded value to its boundary
RTOL = 5e-5  # relative gap of two compared costs
SHOW = 8  # differing decisions listed a stage


def upload_array(img, upload):
    """[3, H, W] linear float32 -> the array the user hands the encoder."""
    if upload == "u8":
        return linear_to_srgb_u8(img)
    return np.ascontiguousarray(img.astype(np.float16 if upload == "f16" else np.float32))


def _bits(t):
    """Tensor -> numpy, floats as their bit patterns (NaN payloads too)."""
    a = t.detach().cpu().contiguous()
    if a.dtype == torch.float32:
        return a.view(torch.int32).numpy()
    if a.dtype == torch.bool:
        return a.numpy().astype(np.int8)
    return a.numpy()


def compare(name, cpu, card, log):
    """One line: the share of `cpu` and `card` values that differ (bit for
    bit), the groups (leading axis) they lie in, and the first one.
    Returns the differing mask (numpy, cpu's shape)."""
    a, b = _bits(cpu), _bits(card)
    diff = a != b
    n = int(diff.sum())
    row = f"{name}: {n} of {diff.size} values differ ({100.0 * n / diff.size:.4f}%)"
    if n:
        first = tuple(int(i) for i in np.argwhere(diff)[0])
        groups = np.flatnonzero(diff.reshape(diff.shape[0], -1).any(axis=1))
        c, d = cpu.detach().cpu()[first].item(), card.detach().cpu()[first].item()
        row += (f" in {len(groups)} groups {groups.tolist()[:SHOW]}"
                f"{'...' if len(groups) > SHOW else ''}; first at {list(first)}: "
                f"card {d!r} cpu {c!r}")
    log(row)
    return diff


def _round_distance(u, boundaries=()):
    """|u| to the nearest k + 1/2, or to one of `boundaries` (arrays)."""
    a = np.abs(np.asarray(u, np.float64))
    dist = np.abs(a - np.floor(a) - 0.5)
    for b in boundaries:
        dist = np.minimum(dist, np.abs(a - np.asarray(b, np.float64)))
    return dist


def decisions(name, diff, dist, unrounded, log, faults):
    """List the differing decisions with the CPU's unrounded value and its
    distance from the boundary; record those farther than TIE."""
    idx = [tuple(int(j) for j in i) for i in np.argwhere(diff)]
    if not idx:
        return
    off = [i for i in idx if not dist[i] <= TIE]
    listed = [(list(i), float(unrounded[i]), float(dist[i])) for i in idx[:SHOW]]
    log(f"{name} ties: {len(idx)} differ, {len(idx) - len(off)} within {TIE} of the "
        f"boundary (index, cpu unrounded, distance): {listed}"
        f"{'...' if len(idx) > SHOW else ''}")
    if off:
        faults.append(name)
        log(f"{name}: NOT AT A TIE: {[(list(i), float(unrounded[i]), float(dist[i])) for i in off[:SHOW]]}")


class _Recorder:
    """Stands in for `torch` in a module of the port and keeps the first
    argument of each call of the functions named: the unrounded values of
    that module's plain arithmetic."""

    def __init__(self, fns):
        self.seen = {fn: [] for fn in fns}

    def __getattr__(self, name):
        if name not in self.seen:
            return getattr(torch, name)

        def record(x, *args, **kwargs):
            self.seen[name].append(x.clone())
            return getattr(torch, name)(x, *args, **kwargs)

        return record


@contextmanager
def recording(module, *fns):
    """{fn: [first argument of each torch.<fn> call inside `module`]}."""
    rec = _Recorder(fns)
    with mock.patch.object(module, "torch", rec):
        yield rec.seen


def _quad_ties(e8, ev, eh, vals):
    """[G,16,16] relative gap of the closest pair of compared costs, and
    the distance of the quad's nearest estimate value from a rounding
    boundary (vals: the 8x8, 16x8 and 8x16 estimate inputs)."""
    e8, ev, eh = (np.asarray(v, np.float64) for v in (e8, ev, eh))
    e00, e01, e10, e11 = e8[:, 0::2, 0::2], e8[:, 0::2, 1::2], e8[:, 1::2, 0::2], e8[:, 1::2, 1::2]
    ev_l, ev_r, eh_t, eh_b = ev[:, :, 0::2], ev[:, :, 1::2], eh[:, 0::2], eh[:, 1::2]
    c16x8 = np.minimum(ev_l, e00 + e10) + np.minimum(ev_r, e01 + e11)
    c8x16 = np.minimum(eh_t, e00 + e01) + np.minimum(eh_b, e10 + e11)
    gap = np.full(c16x8.shape, np.inf)
    for a, b in ((c16x8, c8x16), (ev_l, e00 + e10), (ev_r, e01 + e11), (eh_t, e00 + e01),
                 (eh_b, e10 + e11)):
        gap = np.minimum(gap, np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                                         1e-30))
    v8, vv, vh = (_round_distance(v).min(axis=(1, -1)) for v in vals)
    g = v8.shape[0]
    val = np.minimum(np.minimum(v8.reshape(g, 16, 2, 16, 2).min(axis=(2, 4)),
                                vv.reshape(g, 16, 16, 2).min(axis=3)),
                     vh.reshape(g, 16, 2, 16).min(axis=2))
    return gap, val


def _reproduces(name, got, want, log, faults):
    """The unrounded values recorded for a decision, rounded as the stage
    rounds them, must give the stage's own output; else the distances
    printed would be of other values."""
    if not np.array_equal(np.asarray(got, np.int64), np.asarray(want, np.int64)):
        faults.append(f"{name} record")
        log(f"{name}: the recorded unrounded values do not reproduce the CPU's decisions")


def locate(up, device=None, log=print):
    """Stage-by-stage comparison of program A on `device` (default: the
    card; "cpu" compares the CPU with itself) and the CPU for one upload
    [3, H, W] (u8, float16 or float32). Returns dict(faults: the decisions
    that differ off a tie, bytes: {"card": (size, sha256), "cpu": ...},
    program_groups: groups whose whole-program outputs differ)."""
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    distance = DISTANCE
    distp = compute_distance_params(distance)
    tc, td = device_tables(cpu), device_tables(dev)
    h, w = up.shape[1:]
    yb, xb = PL.group_valid_blocks(h, w, cpu)
    ybd, xbd = PL.group_valid_blocks(h, w, dev)
    faults = []

    def on_card(t):
        return t.to(dev)

    image = torch.from_numpy(np.ascontiguousarray(up))
    groups = PL.extract_groups_device(image)
    compare("extract_groups", groups, PL.extract_groups_device(on_card(image)), log)
    g = groups.shape[0]
    xyb = PL.to_xyb(groups)
    compare("to_xyb", xyb, PL.to_xyb(on_card(groups)), log)

    vec, color = AQ.aq_constants(distance)
    val, gamma, masking = AQ.aq_field_plain(xyb, vec, color)
    for name, a, b in zip(("val", "gamma", "masking"), (val, gamma, masking),
                          AQ.aq_field(on_card(xyb), distance)):
        compare(f"aq_field {name}", a, b, log)
    qf, raw_qf = AQ.aq_tail(val, gamma, distance, distp.inv_scale)
    qf_d, raw_qf_d = AQ.aq_tail(on_card(val), on_card(gamma), distance, distp.inv_scale)
    compare("aq_tail qf", qf, qf_d, log)
    diff = compare("aq_tail raw_qf", raw_qf, raw_qf_d, log)
    u = (qf * float(np.float32(distp.inv_scale)) + 0.5).numpy()
    _reproduces("raw_qf", np.clip(np.trunc(u), 1, 255), raw_qf.numpy(), log, faults)
    decisions("raw_qf", diff, np.abs(u - np.round(u)), u, log, faults)

    blocks8 = xyb.reshape(g, 3, 32, 8, 32, 8).permute(0, 1, 2, 4, 3, 5)
    coef8 = dct2d_8x8(blocks8, tc.dct8)
    compare("dct2d_8x8", coef8, dct2d_8x8(on_card(blocks8), td.dct8), log)

    ar = torch.arange(32)
    valid = (ar[None, :, None] < yb[:, None, None]) & (ar[None, None, :] < xb[:, None, None])
    # round_away (ops/quantize_kernel) takes sign(x) of the unrounded x.
    with recording(QK, "sign") as seen:
        ytox, ytob = PL.compute_cmap(coef8, valid, tc)
    cmap_d = PL.compute_cmap(on_card(coef8), on_card(valid), td)
    for name, a, b, x in zip(("ytox", "ytob"), (ytox, ytob), cmap_d, seen["sign"]):
        diff = compare(f"compute_cmap {name}", a, b, log)
        _reproduces(name, torch.clamp(QK.round_away(x), -128, 127), a, log, faults)
        decisions(name, diff, _round_distance(x.numpy()), x.numpy(), log, faults)

    with recording(SK, "round") as seen:
        e8, ev, eh, coef_v, coef_h = PL.strategy_estimates(
            coef8, qf, masking, ytox, ytob, distance, tc, kernels=False)
    est_d = PL.strategy_estimates(*map(on_card, (coef8, qf, masking, ytox, ytob)), distance,
                                  td, kernels=True)
    for name, a, b in zip(("e8", "ev", "eh", "coef_v", "coef_h"),
                          (e8, ev, eh, coef_v, coef_h), est_d):
        compare(f"strategy_estimates {name}", a, b, log)
    strategy, is_first = PL.decide_strategy(e8, ev, eh, yb, xb)
    strat_d, first_d = PL.decide_strategy(*map(on_card, (e8, ev, eh)), ybd, xbd)
    d_s = compare("strategy", strategy, strat_d, log) | compare("is_first", is_first,
                                                                first_d, log)
    quads = d_s.reshape(g, 16, 2, 16, 2).any(axis=(2, 4))
    if quads.any():
        # One torch.round a family (8x8, 16x8, 8x16), [G,3,R,C,S] each.
        gap, vdist = _quad_ties(e8.numpy(), ev.numpy(), eh.numpy(),
                                [v.numpy() for v in seen["round"]])
        idx = [tuple(int(j) for j in i) for i in np.argwhere(quads)]
        off = [i for i in idx if not (gap[i] <= RTOL or vdist[i] <= TIE)]
        log(f"strategy ties: {len(idx)} quads differ (quad, cost gap, estimate value "
            f"distance): {[(list(i), float(gap[i]), float(vdist[i])) for i in idx[:SHOW]]}")
        if off:
            faults.append("strategy")
            log(f"strategy: NOT AT A TIE: {[list(i) for i in off[:SHOW]]}")
    raw_adj = PL.adjust_quant_field(strategy, is_first, raw_qf)
    compare("adjust_quant_field", raw_adj,
            PL.adjust_quant_field(on_card(strategy), on_card(is_first), on_card(raw_qf)), log)

    args = (coef8, coef_v, coef_h, strategy, is_first, raw_adj, ytox, ytob)
    scal = (distp.scale, distp.scale_dc, distp.x_qm_mul)
    # The quantizer rounds AC values (torch.round) and DC pairs (round_away's
    # sign) of Y, X and B in that order.
    with recording(QK, "round", "sign") as seen:
        m = PL.encode_middle(*args, *scal, tc, kernels=False)
    m_d = PL.encode_middle(*map(on_card, args), *scal, td, kernels=True)
    diff = compare("quantize quant_dc", m["quant_dc"], m_d["quant_dc"], log)
    sy, sx, sb = (t.permute(0, 2, 3, 1) for t in seen["sign"])  # [G,32,32,2]
    u_dc = torch.stack([PL._scatter_covered(t, strategy, is_first) for t in (sx, sy, sb)], 1)
    dcl = float(C.DC_VALUE_CLAMP)
    _reproduces("quant_dc", torch.where(is_first[:, None] | (strategy[:, None] != C.DCT8),
                                        torch.clamp(QK.round_away(u_dc), -dcl, dcl), 0),
                m["quant_dc"], log, faults)
    decisions("quant_dc", diff, _round_distance(u_dc.numpy()), u_dc.numpy(), log, faults)
    diff = compare("quantize AC values", m["ordered"], m_d["ordered"], log)
    s = strategy.long()
    perm = tc.order_tab.long()[s]
    u_ac = torch.stack([torch.gather(seen["round"][k], -1, perm) for k in (0, 1, 2)], dim=3)
    thr = torch.stack([torch.gather(tc.thr_tab[s, c], -1, perm) for c in (1, 0, 2)], dim=3)
    acl = float(C.AC_COEF_CLAMP)
    _reproduces("AC values", torch.clamp(torch.where(u_ac.abs() >= thr, torch.round(u_ac), 0),
                                         -acl, acl), m["ordered"], log, faults)
    decisions("AC values", diff, _round_distance(u_ac.numpy(), (thr.numpy(),)), u_ac.numpy(),
              log, faults)
    cap = 1 << 17
    stream, totals, _ = PL.encode_groups_stream(*args, *scal, valid, cap, tc, kernels=False)
    s_d, t_d, _ = PL.encode_groups_stream(*map(on_card, args), *scal, on_card(valid), cap, td,
                                          kernels=True)
    compare("stream totals", totals, t_d, log)
    # Words past a group's total (the CPU's) are not the stream's.
    n = int(totals.max())
    past = torch.arange(n)[None, :] >= totals[:, None]
    compare("stream words", stream[:, :n].masked_fill(past, 0),
            s_d[:, :n].cpu().masked_fill(past, 0), log)

    # The whole program A and the whole encode, each device on its own.
    sides = {"cpu": (cpu, tc, yb, xb, False), "card": (dev, td, ybd, xbd, True)}
    outs = {k: PL.analyze_groups_packed(PL.extract_groups_device(image.to(d)), ybv, xbv,
                                        distp, cap, tabs, kernels=kern)
            for k, (d, tabs, ybv, xbv, kern) in sides.items()}
    differs = np.zeros(g, bool)
    for k in ("totals", "stream"):
        a, b = _bits(outs["cpu"][k]), _bits(outs["card"][k])
        differs |= (a != b).reshape(g, -1).any(axis=1)
    for a, b in zip(outs["cpu"]["maps"], outs["card"]["maps"]):
        differs |= (_bits(a) != _bits(b)).reshape(g, -1).any(axis=1)
    log(f"program A: groups whose stream, totals or maps differ: "
        f"{np.flatnonzero(differs).tolist()}")
    sizes = {}
    for k, (d, *_) in sides.items():
        data = TE.encode_image_device(up, distance, device=d)
        sizes[k] = (len(data), hashlib.sha256(data).hexdigest())
    log(f"encode: card {sizes['card'][0]} B sha256 {sizes['card'][1]}, cpu "
        f"{sizes['cpu'][0]} B sha256 {sizes['cpu'][1]}: "
        f"{'equal' if sizes['card'] == sizes['cpu'] else 'DIFFERENT'}")
    return dict(faults=faults, bytes=sizes, program_groups=np.flatnonzero(differs).tolist())


def main(argv=None):
    p = argparse.ArgumentParser(prog="jxl_tiny_tpu_torch.tools.device_diff")
    p.add_argument("image", nargs="?", default=PHOTO8MP)
    p.add_argument("--upload", choices=("u8", "f16", "f32"), default="u8")
    args = p.parse_args(argv)
    resolve_device(None)  # no card: raise before reading the image
    up = upload_array(read_pfm(args.image), args.upload)
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    tag = f"device_diff {os.path.basename(args.image)} {args.upload}"
    out = locate(up, log=lambda s: print(f"{tag}: {s}", flush=True))
    return 1 if out["faults"] else 0


if __name__ == "__main__":
    sys.exit(main())
