"""photo8mp's host-path analysis against the JAX package's, on the CPU: where
the two differ, every difference sits at a near-tie of the JAX package's own
float inputs.

The input is a 256x1024 strip of four of photo8mp's group tiles, groups 3,
36, 39 and 60 of its 15x9 grid, where the whole-image analyses differ. Each
group's analysis reads only its own tile (the AQ field pads at the group
edge), so the strip reproduces the whole image's differences.

The two packages compute the same float expressions in the same written
order, but not bit for bit:
- XLA:CPU compiles `to_xyb`'s opsin mix into a fused loop whose results
  differ from the written order on 14-24% of the values (eager JAX and the
  port agree), and `jnp.cbrt` is not correctly rounded (the port's cube
  root is);
- the AQ field's log2 / exp2 tail rounds differently in torch and XLA
  (neither is correctly rounded), and inside a jit XLA contracts the AQ
  arithmetic into FMAs;
- the 8x8 DCT's K=8 contractions run inside XLA's dot, whose summation
  order the port cannot spell out;
- the JAX quantizer runs in interpret mode inside a jit, where XLA may
  contract a*b+c into one FMA.
So a decision whose float input lies within a few ulp of its boundary may
fall the other way. The test holds the principle instead of the bytes:
- `raw_qf`, `ytox` and `ytob` are equal;
- a quad's strategy may differ only where JAX's own costs sit at a
  near-tie: two compared costs within rtol 5e-5 (the bound of
  tests/test_jax_pipeline.py), or an estimate input `val` of the quad (the
  value the entropy estimate rounds) within 1e-4 of a rounding boundary.
  The second criterion goes beyond the cost bound: a value the estimate
  rounds the other way moves a cost by a whole step (here 0.14%), so a
  tie there shows in the costs only as a difference. JAX's `val` comes
  from the JAX package's own estimate arithmetic (strategy_kernel._family,
  evaluated eagerly) on its own inputs;
- a `quant_dc` value outside such a quad may differ by at most 1, and only
  where JAX's unrounded value lies within 1e-4 of a rounding boundary;
- a quantized AC value outside such a quad likewise, where JAX's unrounded
  value lies within 1e-4 of a rounding boundary or of the zero threshold;
- stream words and totals may differ only in the groups where a strategy
  or an AC value differs.
JAX's unrounded quantizer values come from the port's plain arithmetic
(the same expressions in the same order) on the JAX package's own
coefficients, maps and quant fields. Each test prints and asserts its
count."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tiny_tpu import constants as JC
from jxl_tiny_tpu.io.pfm import read_pfm
from jxl_tiny_tpu.ops import pipeline_jax as PJ
from jxl_tiny_tpu.ops import strategy_kernel as JSK
from jxl_tiny_tpu.ops.dct_jax import dct2d
from jxl_tiny_tpu.ops.strategy_kernel import combine_partials as j_combine
from jxl_tiny_tpu.ops.strategy_kernel import estimate_partials as j_estimate

from jxl_tiny_tpu_torch.common import compute_distance_params
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.ops import pipeline_full as PF
from jxl_tiny_tpu_torch.ops import quantize_kernel as QK
from jxl_tiny_tpu_torch.tables import device_tables

F32 = np.float32
TILES = ((0, 3), (2, 6), (2, 9), (4, 0))  # (gy, gx) of groups 3, 36, 39, 60
DISTP = compute_distance_params(1.0)
TABLES = device_tables("cpu")
CAP = 16384
RTOL = 5e-5  # cost pairs (tests/test_jax_pipeline.py)
TIE = 1e-4  # distance of an unrounded value to its boundary
_MAPS = ("strategy", "is_first", "raw_qf", "ytox", "ytob")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def strip(testdata):
    img = read_pfm(os.path.join(testdata, "photo8mp.pfm"))
    return np.ascontiguousarray(np.concatenate(
        [img[:, gy * 256:(gy + 1) * 256, gx * 256:(gx + 1) * 256] for gy, gx in TILES],
        axis=2))


def _valid_blocks():
    yb, xb = PL.group_valid_blocks(256, 1024, "cpu")
    return yb.numpy(), xb.numpy()


@jax.jit
def _jax_decisions(groups, yb, xb):
    """The JAX package's front (pipeline_jax._analyze_groups_fast_impl's
    stages), the strategy costs compute_ac_strategy compares (its own
    estimate_partials and combine_partials on its own inputs) and the
    quantizer's outputs (_encode_middle)."""
    g = groups.shape[0]
    xyb = PJ.to_xyb(groups)
    qf, masking, raw_qf = PJ.adaptive_quant_field(xyb, 1.0, DISTP.inv_scale)
    coef8 = dct2d(xyb.reshape(g, 3, 32, 8, 32, 8).transpose(0, 1, 2, 4, 3, 5), 8, 8)
    ar = jnp.arange(32)
    valid = (ar[None, :, None] < yb[:, None, None]) & (ar[None, None, :] < xb[:, None, None])
    ytox, ytob = PJ.compute_cmap(coef8, valid)
    strategy, is_first, coef_v, coef_h = PJ.compute_ac_strategy(
        xyb, coef8, qf, masking, ytox, ytob, 1.0, yb, xb)
    raw_qf = PJ.adjust_quant_field(strategy, is_first, raw_qf)
    # compute_ac_strategy's cost maps, as it computes them.
    fac_x = jnp.repeat(jnp.repeat(ytox.astype(F32), 8, 1), 8, 2) * JC.INV_COLOR_FACTOR
    fac_b = 1.0 + jnp.repeat(jnp.repeat(ytob.astype(F32), 8, 1), 8, 2) * JC.INV_COLOR_FACTOR
    mul8 = F32(1.0735757687292623 * 0.75 + (-0.55 * 0.75) / 2.4)
    mul16 = F32(0.9019587899705066 + (-0.55) / 2.6)
    q_v = jnp.maximum(qf[:, 0::2], qf[:, 1::2])
    m_v = jnp.maximum(masking[:, 0::2], masking[:, 1::2])
    q_h = jnp.maximum(qf[:, :, 0::2], qf[:, :, 1::2])
    m_h = jnp.maximum(masking[:, :, 0::2], masking[:, :, 1::2])
    p8, pv, ph = j_estimate(
        coef8.reshape(g, 3, 32, 32, 64), coef_v, coef_h, qf, q_v, q_h, masking, m_v, m_h,
        jnp.stack([fac_x, fac_b], axis=1),
        jnp.stack([fac_x[:, 0::2], fac_b[:, 0::2]], axis=1),
        jnp.stack([fac_x[:, :, 0::2], fac_b[:, :, 0::2]], axis=1),
        jnp.asarray(JC.QUANT_DCT8.reshape(3, 64)), jnp.asarray(JC.QUANT_DCT16.reshape(3, 128)),
        1.0 / 3.0)
    m = PJ._encode_middle(coef8.reshape(g, 3, 32, 32, 64), coef_v, coef_h, strategy,
                          is_first, raw_qf, ytox, ytob, DISTP.scale, DISTP.scale_dc,
                          DISTP.x_qm_mul, is_first & valid)
    return dict(
        fac_x=fac_x, fac_b=fac_b, q_v=q_v, q_h=q_h, m_v=m_v, m_h=m_h,
        qf=qf, masking=masking, coef8=coef8, coef_v=coef_v, coef_h=coef_h,
        strategy=strategy, is_first=is_first, raw_qf=raw_qf, ytox=ytox, ytob=ytob,
        e8=F32(3.0) * mul8 + mul8 * j_combine(p8, masking, 1),
        ev=mul16 * j_combine(pv, m_v, 2), eh=mul16 * j_combine(ph, m_h, 2),
        ordered=m["ordered"], quant_dc=m["quant_dc"])


@pytest.fixture(scope="module")
def jx(strip):
    """The JAX package's analysis of the strip (analyze_image_fast) and its
    decisions' float inputs, as numpy arrays."""
    yb, xb = _valid_blocks()
    out = PJ.analyze_image_fast(
        jnp.asarray(strip), jnp.asarray(yb), jnp.asarray(xb), distance=1.0,
        inv_scale=DISTP.inv_scale, scale=DISTP.scale, scale_dc=DISTP.scale_dc,
        x_qm_mul=DISTP.x_qm_mul, cap=CAP)
    groups = PL.extract_groups_device(torch.from_numpy(strip)).numpy()
    dec = _jax_decisions(jnp.asarray(groups), jnp.asarray(yb), jnp.asarray(xb))
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in dec.items()})


@pytest.fixture(scope="module")
def port(strip):
    """The port's analysis of the strip and its quantizer's outputs."""
    yb, xb = PL.group_valid_blocks(256, 1024, "cpu")
    image = torch.from_numpy(strip)
    out = PF.analyze_image_fast(image, yb, xb, DISTP, CAP, TABLES)
    f = PL.analysis_front(PL.extract_groups_device(image), yb, xb, DISTP, TABLES)
    m = PL.encode_middle(f["coef8"], f["coef_v"], f["coef_h"], f["strategy"], f["is_first"],
                         f["raw_qf"], f["ytox"], f["ytob"], DISTP.scale, DISTP.scale_dc,
                         DISTP.x_qm_mul, TABLES, kernels=False)
    return ({k: v.numpy() for k, v in out.items()},
            dict(ordered=m["ordered"].numpy(), quant_dc=m["quant_dc"].numpy()))


class _RoundSpy:
    """Stands in for `torch` in a module of the port and records the
    argument of each torch.round call: the unrounded values of that
    module's plain arithmetic."""

    def __init__(self):
        self.seen = []

    def round(self, x):
        self.seen.append(x.clone())
        return torch.round(x)

    def __getattr__(self, name):
        return getattr(torch, name)


def _t(d, k):
    return torch.from_numpy(np.array(d[k]))


def _tie_distance(v, boundaries=()):
    """Distance of |v| to the nearest rounding boundary k + 1/2, or to one
    of `boundaries`."""
    a = np.abs(np.asarray(v, np.float64))
    dist = np.abs(a - np.floor(a) - 0.5)
    for b in boundaries:
        dist = np.minimum(dist, np.abs(a - np.float64(b)))
    return dist


class _JnpRoundSpy:
    """Stands in for `jnp` in the JAX package's strategy_kernel and records
    the argument of each jnp.round call, as numpy."""

    def __init__(self):
        self.seen = []

    def round(self, x):
        self.seen.append(np.asarray(x))
        return jnp.round(x)

    def __getattr__(self, name):
        return getattr(jnp, name)


def _estimate_vals(dec, monkeypatch):
    """The values JAX's strategy estimate rounds, [G,3,R,C,S] for the 8x8,
    16x8 and 8x16 families: the JAX package's own estimate arithmetic
    (strategy_kernel._family: val = (coef_c - cf * coef_y) * qm * q, the
    kernel's expression) on its own coefficients, quant fields, masking and
    CfL maps. Evaluated eagerly, nothing is contracted into an FMA; for Y
    (cf = 0) the value is the kernel's exactly."""
    g = dec["coef8"].shape[0]
    slope = 1.0 / 3.0
    qm8 = np.asarray(JC.QUANT_DCT8, F32).reshape(3, 64)
    qm16 = np.asarray(JC.QUANT_DCT16, F32).reshape(3, 128)
    fams = (
        (dec["coef8"].reshape(g, 3, 32, 32, 64), qm8, dec["qf"], dec["masking"],
         dec["fac_x"], dec["fac_b"]),
        (dec["coef_v"], qm16, dec["q_v"], dec["m_v"], dec["fac_x"][:, 0::2],
         dec["fac_b"][:, 0::2]),
        (dec["coef_h"], qm16, dec["q_h"], dec["m_h"], dec["fac_x"][:, :, 0::2],
         dec["fac_b"][:, :, 0::2]),
    )
    spy = _JnpRoundSpy()
    monkeypatch.setattr(JSK, "jnp", spy)
    out = []
    for coef, qm, q, m, fx, fb in fams:
        for c, cf in enumerate((fx, np.zeros_like(fx), fb)):
            JSK._family(jnp.asarray(coef[:, c]), jnp.asarray(coef[:, 1]), jnp.asarray(qm[c]),
                        jnp.asarray(q), jnp.asarray(m), jnp.asarray(cf), slope)
        out.append(np.stack(spy.seen[-3:], axis=1))
    monkeypatch.undo()
    return out


def _quant_vals(dec, monkeypatch):
    """JAX's unrounded quantizer values: (AC [G,32,32,3,128] in emission
    layout and zig-zag order, its zero thresholds alike, DC [G,3,32,32]):
    the port's plain quantizer on the JAX package's inputs."""
    g = dec["coef8"].shape[0]
    strategy = _t(dec, "strategy").to(torch.int32)
    fac_x, fac_b = PL.cfl_factors(_t(dec, "ytox"), _t(dec, "ytob"))
    spy, dc = _RoundSpy(), []
    real_round_away = QK.round_away

    def round_away(x):
        dc.append(x.clone())
        return real_round_away(x)

    monkeypatch.setattr(QK, "torch", spy)
    monkeypatch.setattr(QK, "round_away", round_away)
    QK.quantize_cells_plain(
        _t(dec, "coef8").reshape(g, 3, 32, 32, 64).contiguous(), _t(dec, "coef_v"),
        _t(dec, "coef_h"), strategy, _t(dec, "raw_qf").to(torch.int32), fac_x, fac_b,
        TABLES, DISTP.scale, DISTP.scale_dc, DISTP.x_qm_mul)
    monkeypatch.undo()
    s = strategy.long()
    perm = TABLES.order_tab.long()[s]
    vy, vx, vb = (torch.gather(v, -1, perm) for v in spy.seen)  # rounded Y, X, B
    thr = [torch.gather(TABLES.thr_tab[s, c], -1, perm) for c in (1, 0, 2)]
    ac = torch.stack([vy, vx, vb], dim=3).numpy()
    ac_thr = torch.stack(thr, dim=3).numpy()
    uy, ux, ub = dc  # per-first-cell pairs [G, 2, 32, 32]
    is_first = _t(dec, "is_first")
    dc_cells = torch.stack([PL._scatter_covered(u.permute(0, 2, 3, 1), strategy, is_first)
                            for u in (ux, uy, ub)], dim=1).numpy()
    return ac, ac_thr, dc_cells


def _flipped_quads(jx_, port_):
    """[G, 16, 16] bool: quads where the strategy or is_first maps differ."""
    out, _ = jx_
    p, _ = port_
    d = ((p["strategy"] != out["strategy"]) | (p["is_first"] != out["is_first"]))
    return d.reshape(-1, 16, 2, 16, 2).any(axis=(2, 4))


def _cells(quads):
    return np.repeat(np.repeat(quads, 2, axis=1), 2, axis=2)


def test_jax_decisions_are_its_analysis(jx):
    """The JAX package's decisions computed stage by stage are those of its
    analyze_image_fast, so their float inputs are the ones it decided on."""
    out, dec = jx
    for k in _MAPS:
        assert np.array_equal(out[k].astype(np.int64), dec[k].astype(np.int64)), k
    assert np.array_equal(out["quant_dc"].astype(np.int64), dec["quant_dc"])


def test_raw_qf_and_cfl_maps_equal(jx, port):
    out, _ = jx
    p, _ = port
    for k in ("raw_qf", "ytox", "ytob"):
        assert np.array_equal(p[k].astype(np.int64), out[k].astype(np.int64)), k


def _strategy_ties(dec, monkeypatch):
    """[G, 16, 16] bool each: quads where two of the costs JAX compares lie
    within rtol RTOL, and quads holding an estimate value within TIE of a
    rounding boundary; and the estimate values (_estimate_vals)."""
    e8, ev, eh = dec["e8"], dec["ev"], dec["eh"]
    e00, e01, e10, e11 = e8[:, 0::2, 0::2], e8[:, 0::2, 1::2], e8[:, 1::2, 0::2], e8[:, 1::2, 1::2]
    ev_l, ev_r, eh_t, eh_b = ev[:, :, 0::2], ev[:, :, 1::2], eh[:, 0::2], eh[:, 1::2]
    cost16x8 = np.minimum(ev_l, e00 + e10) + np.minimum(ev_r, e01 + e11)
    cost8x16 = np.minimum(eh_t, e00 + e01) + np.minimum(eh_b, e10 + e11)
    pairs = ((cost16x8, cost8x16), (ev_l, e00 + e10), (ev_r, e01 + e11),
             (eh_t, e00 + e01), (eh_b, e10 + e11))
    cost_tie = np.zeros(cost16x8.shape, bool)
    for a, b in pairs:
        cost_tie |= np.abs(a - b) <= RTOL * np.maximum(np.abs(a), np.abs(b))
    vals = _estimate_vals(dec, monkeypatch)
    v8, vv, vh = (_tie_distance(v).min(axis=(1, -1)) for v in vals)
    g = v8.shape[0]
    val_tie = np.minimum(
        np.minimum(v8.reshape(g, 16, 2, 16, 2).min(axis=(2, 4)),
                   vv.reshape(g, 16, 16, 2).min(axis=3)),
        vh.reshape(g, 16, 2, 16).min(axis=2)) <= TIE
    return cost_tie, val_tie, vals


def test_strategy_flips_sit_at_ties(jx, port, monkeypatch):
    _, dec = jx
    quads = _flipped_quads(jx, port)
    cost_tie, val_tie, vals = _strategy_ties(dec, monkeypatch)
    unexplained = quads & ~(cost_tie | val_tie)
    print(f"quads whose strategy differs: {int(quads.sum())} (at {np.argwhere(quads).tolist()}); "
          f"costs within rtol {RTOL}: {int((quads & cost_tie).sum())}; an estimate value "
          f"within {TIE} of a rounding boundary: {int((quads & val_tie).sum())}")
    assert not unexplained.any(), np.argwhere(unexplained).tolist()
    assert np.argwhere(quads).tolist() == [[3, 4, 11]]
    # Group 60's quad (4, 11): in JAX's own 16x8 estimate, coefficient 35 of
    # the Y cell (4, 22) rounds at -0.5000014 (the port's: -0.4999977).
    y16x8 = vals[1][3, 1, 4, 22]
    assert abs(float(y16x8[35]) + 0.5) <= TIE
    assert np.argmin(_tie_distance(y16x8)) == 35


def test_quant_dc_differs_only_at_ties(jx, port, monkeypatch):
    out, dec = jx
    p, _ = port
    diff = p["quant_dc"].astype(np.int64) - out["quant_dc"].astype(np.int64)
    in_flip = _cells(_flipped_quads(jx, port))[:, None].repeat(3, axis=1)
    _, _, u = _quant_vals(dec, monkeypatch)
    at_tie = (np.abs(diff) <= 1) & (_tie_distance(u) <= TIE)
    unexplained = (diff != 0) & ~in_flip & ~at_tie
    n_tie = int(((diff != 0) & ~in_flip & at_tie).sum())
    n_flip = int(((diff != 0) & in_flip).sum())
    print(f"quant_dc values that differ: {int((diff != 0).sum())}; at a rounding tie "
          f"(|JAX unrounded - boundary| <= {TIE}): {n_tie} "
          f"{[(i.tolist(), float(u[tuple(i)])) for i in np.argwhere((diff != 0) & ~in_flip)]}; "
          f"inside a quad whose strategy differs: {n_flip}")
    assert not unexplained.any(), np.argwhere(unexplained).tolist()
    assert (n_tie, n_flip) == (3, 1)


def test_ac_values_differ_only_at_ties(jx, port, monkeypatch):
    _, dec = jx
    _, pm = port
    diff = pm["ordered"].astype(np.int64) - dec["ordered"].astype(np.int64)
    in_flip = _cells(_flipped_quads(jx, port))[..., None, None]
    u, thr, _ = _quant_vals(dec, monkeypatch)
    dist = np.minimum(_tie_distance(u), np.abs(np.abs(u) - thr))
    at_tie = (np.abs(diff) <= 1) & (dist <= TIE)
    unexplained = (diff != 0) & ~in_flip & ~at_tie
    n_tie = int(((diff != 0) & ~in_flip & at_tie).sum())
    print(f"quantized AC values that differ: {int((diff != 0).sum())}; outside the quads "
          f"whose strategy differs, at a rounding or zero-threshold tie: {n_tie} "
          f"{[(i.tolist(), float(u[tuple(i)])) for i in np.argwhere((diff != 0) & ~in_flip)]}")
    assert not unexplained.any(), np.argwhere(unexplained).tolist()
    assert n_tie == 2


def test_streams_differ_only_where_decisions_differ(jx, port):
    out, dec = jx
    p, pm = port
    decided = (_flipped_quads(jx, port).any(axis=(1, 2))
               | (pm["ordered"] != dec["ordered"]).reshape(len(p["totals"]), -1).any(axis=1))
    words = (p["stream"] != out["stream"].view(np.int32)).sum(axis=1)
    differs = (words > 0) | (p["totals"] != out["totals"])
    print(f"groups whose stream differs: {np.flatnonzero(differs).tolist()} ({words.tolist()} "
          f"words); groups where a strategy or an AC value differs: "
          f"{np.flatnonzero(decided).tolist()}")
    assert not (differs & ~decided).any()
    assert np.flatnonzero(differs).tolist() == [1, 3]
