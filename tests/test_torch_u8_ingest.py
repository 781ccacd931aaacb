"""The 8-bit sRGB ingest against the JAX package, on the CPU.

The port linearizes u8 samples through constants.SRGB_U8_TO_LINEAR, the
JAX package's own values: its extract_groups_device computes exp(2.4 *
log(.)) in XLA, which is no correctly rounded pow (195 of the 256 values
differ from a float64 result rounded once), so the table is copied, not
rebuilt from the formula.

- the table equals JAX's extract_groups_device on all 256 values, at two
  image shapes, and lies within 1e-5 of the formula (the numpy twin
  io/color.srgb_u8_to_linear and the torch expression the port used
  before the table);
- the four small images as u8, both configurations: the port's CPU bytes
  are chip_smoke.py's U8_CPU_DIGESTS; at the default configuration the
  JAX package's program A on the u8 upload (one JAX compile an image)
  leads to those bytes for tiny64, odd131x77 and photo256, and
  gradient512 (11,724 B, JAX 11,725 B) differs;
- that one difference sits at a near-tie of JAX's own inputs (the rules
  of tests/test_torch_neartie.py): every map is equal, and two quantized
  AC values of one 16x8 transform (group 3, cells (16, 2) and (17, 2), X,
  zig-zag position 2) round at JAX's -1.5000039 to -2 and at the port's
  value to -1;
- tools/device_diff.py, the locator of card-against-CPU differences, on
  the CPU against itself and on its tie rule;
- on the card (`gpu`), the table gather equals the CPU's result.

JAX is imported inside the CPU tests only: the card's machine has none."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu_torch import constants as C
from jxl_tiny_tpu_torch import encoder as TE
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.encoder import encode_image_device
from jxl_tiny_tpu_torch.io.color import linear_to_srgb_u8, srgb_u8_to_linear
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import pipeline as PL

HERE = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(HERE, "..", "testdata")
F32 = np.float32
CONFIGS = {"default": EncoderConfig(), "fixed 8x8": EncoderConfig(optimize_block_sizes=False)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DIGESTS = _chip_smoke().U8_CPU_DIGESTS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _every_value(h, w):
    """[3, h, w] u8 holding every value, each channel shifted."""
    v = np.arange(3 * h * w, dtype=np.int64).reshape(3, h, w)
    return ((v * 7 + np.arange(3)[:, None, None] * 85) % 256).astype(np.uint8)


def _per_value(u8, groups):
    """The linear value each u8 value maps to in [G,3,256,256] groups of a
    [3,h,w] image, asserting that each value maps to one float."""
    _, h, w = u8.shape
    gy, gx = -(-h // 256), -(-w // 256)
    full = groups.reshape(gy, gx, 3, 256, 256).transpose(2, 0, 3, 1, 4).reshape(
        3, gy * 256, gx * 256)[:, :h, :w]
    out = np.zeros(256, np.float32)
    for k in range(256):
        vals = np.unique(full[u8 == k].view(np.uint32))
        assert len(vals) == 1, (k, vals)
        out[k] = vals.view(np.float32)[0]
    return out


def _formula_torch(u8):
    """The torch expression of the IEC 61966-2-1 EOTF the port computed
    before it read the table (float32 exp(2.4 * log(.)))."""
    x = u8.to(torch.float32) * float(F32(1.0 / 255.0))
    lin = torch.exp(2.4 * torch.log(
        torch.clamp_min((x + float(F32(0.055))) * float(F32(1.0 / 1.055)), 1e-7)))
    return torch.where(x <= float(F32(0.04045)), x * float(F32(1.0 / 12.92)), lin)


@pytest.mark.parametrize("shape", [(256, 256), (77, 131)])
def test_table_is_jax_extract_groups(shape):
    import jax.numpy as jnp
    from jxl_tiny_tpu.ops import pipeline_jax as PJ

    u8 = _every_value(*shape)
    want = _per_value(u8, np.asarray(PJ.extract_groups_device(jnp.asarray(u8))))
    assert np.array_equal(C.SRGB_U8_TO_LINEAR.view(np.uint32), want.view(np.uint32))
    got = PL.extract_groups_device(torch.from_numpy(u8)).numpy()
    assert np.array_equal(_per_value(u8, got).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("twin", ["numpy", "torch"])
def test_table_near_formula(twin):
    v = np.arange(256, dtype=np.uint8)
    f = (srgb_u8_to_linear(v) if twin == "numpy"
         else _formula_torch(torch.from_numpy(v)).numpy())
    assert C.SRGB_U8_TO_LINEAR.dtype == np.float32 and C.SRGB_U8_TO_LINEAR.shape == (256,)
    np.testing.assert_allclose(C.SRGB_U8_TO_LINEAR, f, rtol=1e-5, atol=0)
    n = int((C.SRGB_U8_TO_LINEAR != f).sum())
    print(f"values where the table differs from the {twin} formula: {n} of 256")


@pytest.mark.parametrize("label,name", [(label, name) for label in DIGESTS
                                        for name in DIGESTS[label]])
def test_small_images_u8_digests(label, name):
    """chip_smoke.py's U8_CPU_DIGESTS are the port's CPU streams."""
    u8 = linear_to_srgb_u8(read_pfm(os.path.join(TESTDATA, f"{name}.pfm")))
    got = encode_image_device(u8, 1.0, config=CONFIGS[label], device="cpu")
    assert (len(got), hashlib.sha256(got).hexdigest()) == DIGESTS[label][name]


def _jax_program_a(u8, cap):
    """The JAX package's program A (its device program: its own u8 ingest
    and analysis) on one u8 image, as the port's program A returns it."""
    import jax.numpy as jnp
    from jxl_tiny_tpu.common import compute_distance_params
    from jxl_tiny_tpu.ops import pipeline_jax as PJ

    d = compute_distance_params(1.0)
    yb, xb = (v.numpy() for v in PL.group_valid_blocks(*u8.shape[1:], "cpu"))
    out = {k: np.asarray(v) for k, v in PJ.analyze_image_packed(
        jnp.asarray(u8), jnp.asarray(yb), jnp.asarray(xb), distance=float(d.distance),
        inv_scale=float(d.inv_scale), scale=float(d.scale), scale_dc=float(d.scale_dc),
        x_qm_mul=float(d.x_qm_mul), cap=cap, cfl=True, blocks=True).items()}
    return dict(stream=torch.from_numpy(out["stream"].view(np.int32).copy()),
                totals=torch.from_numpy(out["totals"].astype(np.int64)),
                hists=torch.from_numpy(out["hists"].astype(np.int64))[None],
                dc_layout=torch.from_numpy(out["dc_layout"].view(np.int32).copy()))


@pytest.mark.parametrize("name", ["tiny64", "odd131x77", "photo256"])
def test_small_images_u8_match_jax(name, monkeypatch):
    """At the default configuration the JAX package's program A on the u8
    upload, handed to the port's program B and assembly (which give the
    JAX package's bytes on its program A outputs: tests/test_torch_encode.py
    (b)), gives the port's own stream (gradient512: the next test)."""
    u8 = linear_to_srgb_u8(read_pfm(os.path.join(TESTDATA, f"{name}.pfm")))
    caps = []

    def jax_program_a(images, yb, xb, distp, cap, tables, cfl=True, blocks=True,
                      kernels=True):
        assert cfl and blocks and images.shape[0] == 1
        caps.append(cap)
        return _jax_program_a(images[0].numpy(), cap)

    monkeypatch.setattr(TE, "analyze_batch_packed", jax_program_a)
    got = encode_image_device(u8, 1.0, device="cpu")
    assert caps and hashlib.sha256(got).hexdigest() == DIGESTS["default"][name][1]


def test_gradient512_u8_differs_only_at_ties(monkeypatch):
    """gradient512 as u8, default configuration: JAX's analysis (its own
    ingest, then test_torch_neartie._jax_decisions) against the port's.
    Every map is equal; the quantized AC values differ in two cells of one
    16x8 transform, where JAX's unrounded value lies within the near-tie
    bound of a rounding boundary."""
    import jax.numpy as jnp
    from jxl_tiny_tpu.ops import pipeline_jax as PJ

    import test_torch_neartie as NT

    u8 = linear_to_srgb_u8(read_pfm(os.path.join(TESTDATA, "gradient512.pfm")))
    yb, xb = PL.group_valid_blocks(512, 512, "cpu")
    groups = np.asarray(PJ.extract_groups_device(jnp.asarray(u8)))
    dec = {k: np.asarray(v) for k, v in NT._jax_decisions(
        jnp.asarray(groups), jnp.asarray(yb.numpy()), jnp.asarray(xb.numpy())).items()}
    f = PL.analysis_front(PL.extract_groups_device(torch.from_numpy(u8)), yb, xb, NT.DISTP,
                          NT.TABLES)
    m = PL.encode_middle(f["coef8"], f["coef_v"], f["coef_h"], f["strategy"], f["is_first"],
                         f["raw_qf"], f["ytox"], f["ytob"], NT.DISTP.scale, NT.DISTP.scale_dc,
                         NT.DISTP.x_qm_mul, NT.TABLES, kernels=False)
    for k in NT._MAPS:
        assert np.array_equal(f[k].numpy().astype(np.int64), dec[k].astype(np.int64)), k
    assert np.array_equal(m["quant_dc"].numpy().astype(np.int64), dec["quant_dc"])
    got = m["ordered"].numpy().astype(np.int64)
    diff = got - dec["ordered"].astype(np.int64)
    u, thr, _ = NT._quant_vals(dec, monkeypatch)
    pu, _, _ = NT._quant_vals({k: v.numpy() for k, v in f.items()}, monkeypatch)
    dist = np.minimum(NT._tie_distance(u), np.abs(np.abs(u) - thr))
    where = [tuple(i) for i in np.argwhere(diff != 0)]
    print(f"quantized AC values that differ (index, JAX, port, JAX unrounded, port "
          f"unrounded): {[(list(map(int, i)), int(dec['ordered'][i]), int(got[i]), float(u[i]), float(pu[i])) for i in where]}")
    assert not ((diff != 0) & ~((np.abs(diff) <= 1) & (dist <= NT.TIE))).any()
    # Group 3, cells (16, 2) and (17, 2) (one 16x8 transform), X, zig-zag 2.
    assert where == [(3, 16, 2, 1, 2), (3, 17, 2, 1, 2)]
    assert dec["strategy"][3, 16, 2] == C.DCT16X8 and dec["is_first"][3, 16, 2]
    for i in where:
        assert (int(dec["ordered"][i]), int(got[i])) == (-2, -1)
        assert -1.5 - NT.TIE <= float(u[i]) < -1.5 < float(pu[i]) <= -1.5 + NT.TIE


def test_device_diff_cpu_against_itself():
    """tools/device_diff on the CPU against itself: every stage equal, each
    decision's recorded unrounded values reproduce it, the bytes are the
    digest's."""
    from jxl_tiny_tpu_torch.tools import device_diff as DD

    lines = []
    u8 = DD.upload_array(read_pfm(os.path.join(TESTDATA, "odd131x77.pfm")), "u8")
    out = DD.locate(u8, device="cpu", log=lines.append)
    stages = [s for s in lines if "values differ" in s]
    assert len(stages) == 22 and all(" 0 of " in s for s in stages), lines
    assert out["faults"] == [] and out["program_groups"] == []
    assert out["bytes"]["card"] == out["bytes"]["cpu"] == DIGESTS["default"]["odd131x77"]


def test_device_diff_flags_decisions_off_a_tie():
    from jxl_tiny_tpu_torch.tools import device_diff as DD

    u = np.array([2.49995, 0.3, 7.0])
    dist = DD._round_distance(u)
    lines, faults = [], []
    DD.decisions("x", np.array([True, False, False]), dist, u, lines.append, faults)
    assert faults == [] and "1 within" in lines[0]
    DD.decisions("x", np.array([True, True, False]), dist, u, lines.append, faults)
    assert faults == ["x"] and "NOT AT A TIE" in lines[-1]
    assert DD._round_distance([0.57], ([0.574],))[0] == pytest.approx(0.004)


def test_device_diff_needs_a_card(monkeypatch):
    from jxl_tiny_tpu_torch.tools import device_diff as DD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DD.main([])


@pytest.mark.gpu
def test_table_gather_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    u8 = torch.from_numpy(_every_value(300, 530))
    want = PL.extract_groups_device(u8)
    got = PL.extract_groups_device(u8.to("cuda"))
    assert got.dtype == torch.float32 and torch.equal(got.cpu().view(torch.int32),
                                                      want.view(torch.int32))
    assert np.array_equal(_per_value(u8.numpy(), got.cpu().numpy()).view(np.uint32),
                          C.SRGB_U8_TO_LINEAR.view(np.uint32))
