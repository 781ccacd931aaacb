"""photo8mp at full size (3840x2160, 135 groups, 4 DC groups): the port's
encode_image_device on the CPU against the JAX package's, at d=1.0 in the
default configuration, for both uploads a user sends an 8 MP photograph
in: linear float (travels as float16, as both packages upload an image
past F16_AUTO_F32_PIXELS) and 8-bit sRGB (linearized on the device).

The port's other CPU comparisons reach a 512x512 crop of this image
(tests/test_torch_encode.py); this one is the whole image, so it is
`slow` (run with --runslow). The codestreams differ by 2 bytes in both
uploads (below), so the test holds the principle of tests/test_torch_neartie.py
instead of the bytes, on program A's decisions group by group (JAX's
from its device-path program A, the port's from its own):
- raw_qf, ytox and ytob are equal;
- a quad's strategy may differ only where JAX's own costs sit at a
  near-tie (two compared costs within rtol 5e-5, or an estimate value of
  the quad within 1e-4 of a rounding boundary);
- a quant_dc value or a quantized AC value outside such a quad may differ
  by at most 1, and only where JAX's unrounded value lies within 1e-4 of a
  rounding boundary (AC: or of the zero threshold); B's quant_dc, coded
  against Y's, may also follow a Y value that differs so;
- token streams differ only in groups where a strategy or an AC value
  differs.
JAX's float inputs are recomputed stage by stage on the groups that differ
(test_torch_neartie._jax_decisions, on JAX's own extracted groups). With
the float16 upload they give JAX's device-path decisions exactly. With the
8-bit upload the stage-by-stage groups come from JAX's eager
extract_groups_device, whose values the port copies (constants.
SRGB_U8_TO_LINEAR), so the port's pixels equal them bit for bit; JAX's
device-path program linearizes inside its own compilation, which rounds
some of the 256 values otherwise (a jit of extract_groups_device alone, at
this shape, 46 of them), and JAX's two computations themselves disagree
on one strategy quad and one quant_dc value; the test holds those to JAX's
own ties too.

Measured (the port and JAX on the CPU): float16 378,440 B against
378,438 B, four quant_dc values at ties and two AC values at the zero
threshold in one group; uint8 384,020 B (the card's stream too) against
384,019 B, three strategy quads (groups 6, 11 and 95) and five quant_dc
values at ties (301.49997, 188.50002, 275.49997, -3.5, 296.50003), one B
value following its Y, and two AC values at the zero threshold (group 88,
0.5740002)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tiny_tpu import encoder as JE
from jxl_tiny_tpu.io.color import linear_to_srgb_u8 as jax_to_u8
from jxl_tiny_tpu.ops import pipeline_jax as PJ

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.ops import quantize_kernel as QK

import test_torch_neartie as NT

PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "testdata",
                     "photo8mp.pfm")
MAPS = ("quant_dc", "raw_qf", "strategy", "is_first", "ytox", "ytob")


def _encodes(kind):
    """(JAX job, JAX bytes, port job, port bytes, port maps {name: [G, ...]})."""
    img = read_pfm(PHOTO)
    if kind == "uint8":
        u8 = linear_to_srgb_u8(img)
        assert np.array_equal(u8, jax_to_u8(img))
        img = u8
    jj = JE.DeviceEncodeJob(img, 1.0)
    jj.pack()
    want = jj.result()
    maps, real = [], PL.dc_layout_from_maps

    def spy(*args, **kwargs):
        maps.append(args)
        return real(*args, **kwargs)

    PL.dc_layout_from_maps = spy
    try:
        pj = TE.DeviceEncodeJob([img], 1.0, device="cpu")
    finally:
        PL.dc_layout_from_maps = real
    got = pj.result()[0]
    return jj, want, pj, got, {k: v.numpy() for k, v in zip(MAPS, maps[0])}


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["float16", "uint8"])
def test_photo8mp_full_size_against_jax(kind, monkeypatch):
    jj, want, pj, got, pmaps = _encodes(kind)
    print(f"photo8mp ({kind}): port {len(got)} B, JAX package {len(want)} B")
    if got == want:
        return
    jm = PJ.unpack_meta_u8(np.asarray(jj.out_a["meta"]))
    j_stream, j_totals = np.asarray(jj.out_a["stream"]), np.asarray(jj.out_a["totals"])
    p_stream, p_totals = pj.out_a["stream"].numpy().view(np.uint32), pj.out_a["totals"].numpy()
    stream_differs = (p_totals != j_totals) | (p_stream != j_stream).any(axis=1)
    map_differs = np.zeros_like(stream_differs)
    for k in MAPS:
        a = jm[k].astype(np.int64).reshape(len(j_totals), -1)
        map_differs |= (a != pmaps[k].astype(np.int64).reshape(len(j_totals), -1)).any(axis=1)
    sel = np.flatnonzero(map_differs | stream_differs)
    print(f"groups whose maps differ: {np.flatnonzero(map_differs).tolist()}; whose stream "
          f"differs: {np.flatnonzero(stream_differs).tolist()}")

    # JAX's float inputs on those groups, from its own extracted groups.
    yb, xb = (v.numpy()[sel] for v in PL.group_valid_blocks(2160, 3840, "cpu"))
    groups = np.asarray(PJ.extract_groups_device(jnp.asarray(jj._up)))[sel]
    dec = {k: np.asarray(v) for k, v in NT._jax_decisions(
        jnp.asarray(groups), jnp.asarray(yb), jnp.asarray(xb)).items()}
    out = {k: jm[k][sel] for k in MAPS}
    u_ac, thr, u_dc = NT._quant_vals(dec, monkeypatch)
    self_diff = {k: int((out[k].astype(np.int64) != dec[k].astype(np.int64)).sum())
                 for k in MAPS}
    print(f"JAX's decisions recomputed stage by stage against its device path: values "
          f"that differ {self_diff}")
    for k in ("raw_qf", "ytox", "ytob"):
        assert np.array_equal(out[k].astype(np.int64), dec[k].astype(np.int64)), k
    p = {k: pmaps[k][sel] for k in MAPS}
    for k in ("raw_qf", "ytox", "ytob"):
        assert np.array_equal(p[k].astype(np.int64), out[k].astype(np.int64)), k
    cost_tie, val_tie, _ = NT._strategy_ties(dec, monkeypatch)
    ties = cost_tie | val_tie
    # Where JAX's stage-by-stage decisions differ from its device path's (two
    # XLA compilations of the same arithmetic: the u8 upload), JAX sits at a
    # tie of its own.
    self_quads = NT._flipped_quads((out, None), (dec, None))
    d_self = out["quant_dc"].astype(np.int64) - dec["quant_dc"].astype(np.int64)
    self_flip = NT._cells(self_quads)[:, None].repeat(3, axis=1)
    print(f"JAX's own: quads whose strategy differs {np.argwhere(self_quads).tolist()}, at a "
          f"cost or estimate tie {np.argwhere(self_quads & ties).tolist()}; quant_dc values "
          f"outside them, with JAX's unrounded value: "
          f"{[(i.tolist(), float(u_dc[tuple(i)])) for i in np.argwhere((d_self != 0) & ~self_flip)]}")
    assert not (self_quads & ~ties).any()
    assert not ((d_self != 0) & ~self_flip & ~((np.abs(d_self) <= 1)
                                              & (NT._tie_distance(u_dc) <= NT.TIE))).any()

    # The port's strategy flips at JAX's near-ties.
    quads = NT._flipped_quads((out, None), (p, None))
    print(f"quads whose strategy differs from the port's: {np.argwhere(quads).tolist()}, at a "
          f"tie {np.argwhere(quads & ties).tolist()}")
    assert not (quads & ~ties).any(), np.argwhere(quads).tolist()
    in_flip = NT._cells(quads | self_quads)

    # quant_dc and AC values at JAX's rounding or zero-threshold ties; the
    # port's quantized AC values from its own front on its own groups.
    f = PL.analysis_front(PL.extract_groups_device(pj._up)[torch.from_numpy(sel)],
                          torch.from_numpy(yb), torch.from_numpy(xb), NT.DISTP, NT.TABLES)
    m = PL.encode_middle(f["coef8"], f["coef_v"], f["coef_h"], f["strategy"], f["is_first"],
                         f["raw_qf"], f["ytox"], f["ytob"], NT.DISTP.scale, NT.DISTP.scale_dc,
                         NT.DISTP.x_qm_mul, NT.TABLES, kernels=False)
    assert np.array_equal(f["strategy"].numpy(), p["strategy"])
    d_dc = p["quant_dc"].astype(np.int64) - out["quant_dc"].astype(np.int64)
    dc_flip = in_flip[:, None].repeat(3, axis=1)
    dc_tie = (np.abs(d_dc) <= 1) & (NT._tie_distance(u_dc) <= NT.TIE)
    # B's DC is coded against Y's quantized DC (qdc_b = round(dc_b - qdc_y *
    # cfl_b)): where Y's value differs at a tie, B's follows from the port's
    # Y, rounded as the quantizer rounds.
    cfl_b = np.float64(QK.quant_scalars(NT.DISTP.scale, NT.DISTP.scale_dc,
                                        NT.DISTP.x_qm_mul)["cfl_b"])
    u_b = u_dc[:, 2].astype(np.float64) - d_dc[:, 1] * cfl_b
    follows = (d_dc[:, 1] != 0) & (np.sign(u_b) * np.floor(np.abs(u_b) + 0.5)
                                   == p["quant_dc"][:, 2])
    dc_tie[:, 2] |= follows
    d_ac = m["ordered"].numpy().astype(np.int64) - dec["ordered"].astype(np.int64)
    ac_flip = in_flip[..., None, None]
    dist = np.minimum(NT._tie_distance(u_ac), np.abs(np.abs(u_ac) - thr))
    ac_tie = (np.abs(d_ac) <= 1) & (dist <= NT.TIE)
    print(f"quads whose strategy differs: {np.argwhere(quads).tolist()} (groups "
          f"{sel.tolist()}); quant_dc values that differ outside them, with JAX's unrounded "
          f"value: {[(i.tolist(), float(u_dc[tuple(i)])) for i in np.argwhere((d_dc != 0) & ~dc_flip)]}"
          f"; AC values: {[(i.tolist(), float(u_ac[tuple(i)])) for i in np.argwhere((d_ac != 0) & ~ac_flip)]}")
    assert not ((d_dc != 0) & ~dc_flip & ~dc_tie).any()
    assert not ((d_ac != 0) & ~ac_flip & ~ac_tie).any()

    decided = quads.any(axis=(1, 2)) | (d_ac != 0).reshape(len(sel), -1).any(axis=1)
    assert not (stream_differs[sel] & ~decided).any()
