"""The check that decides `correct`, shown to fail: the lower-precision
control against the cells' limits, and a run with the timed path broken
underneath (a token altered where it is produced, a codestream altered,
a field of the header that assembly writes altered, half of a batch left
out). The run skips the look for a card and drives
everything else of run_cell on the CPU. The last test runs a cell on the
card and skips without one."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import helpers as H
from jxlbench import spec
from jxlbench.check import Checker, summarize
from jxlbench.inputs import make_pool, read_pfm
from jxlbench.reference import golden


def _limits(cell):
    with open(os.path.join(spec.BENCH_DIR, "limits", cell + ".json")) as f:
        return json.load(f)


def _fails(nums, limits):
    return [k for k, v in nums.items() if v > limits[k]]


@pytest.fixture(scope="module")
def crop():
    img = read_pfm(os.path.join(H.ROOT, "testdata", "photo8mp.pfm"))
    return np.ascontiguousarray(img[:, 1000:1512, 2000:2768])


@pytest.mark.parametrize("cell, precision, pixels", [
    ("photo8mp-d1.u8.single", "bfloat16", "u8"),
    ("photo8mp-d1.u8.stream", "bfloat16", "u8"),
    ("tiles1024-d1.u8.batch64", "bfloat16", "u8"),
    ("photo8mp-d1.f32.single", "bfloat16", "f32"),
])
def test_control_fails_the_cells_limits(crop, cell, precision, pixels):
    """The golden model one precision below the configuration's in the
    program's place (bfloat16 data for its float32 arithmetic) fails at
    least one number, at a 768x512 crop."""
    if pixels == "u8":
        ref = golden.srgb_u8_to_linear_table()[golden.linear_to_srgb_u8(crop)]
    else:
        ref = crop.astype(np.float16).astype(np.float32)
    with Checker(4) as ch:
        nums = summarize(ch.control(ref, 1.0, precision))
    assert _fails(nums, _limits(cell)), nums


def _alter_one_token(out):
    """Program A's first token word (`context << 16 | value`) of value 2 or
    more gets its value moved by 2: the coefficient it codes moves by
    one."""
    stream = out["stream"].clone()
    flat = stream.view(-1)
    k = int(((flat & 0xFFFF) >= 2).nonzero()[0, 0])
    flat[k] ^= 2
    out["stream"] = stream
    return out


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from jxl_tiny_tpu_torch import encoder

    real = encoder.analyze_batch_packed
    monkeypatch.setattr(encoder, "analyze_batch_packed",
                        lambda *a, **k: _alter_one_token(real(*a, **k)))
    r = H.run(H.small_cell("u8.single"), seed=21)
    assert not r["correct"], r["check"]


def test_an_answer_altered_is_not_correct():
    from jxl_tiny_tpu_torch import encoder

    def altered(img, distance):
        data = bytearray(encoder.encode_image_device(img, distance, device="cpu"))
        data[len(data) // 2] ^= 0x10
        return bytes(data)

    r = H.run(H.small_cell("u8.single"), H.cpu_encoder(encode_image_device=altered), seed=22)
    assert not r["correct"]


def _write_quant_scales_off(real, which):
    def write(writer, global_scale, quant_dc):
        if which == "global_scale":
            global_scale += 1
        else:
            quant_dc += 1
        return real(writer, global_scale, quant_dc)

    return write


def _write_frame_header_off(real, which):
    def write(writer, x_qm_scale, epf_iters):
        if which == "x_qm_scale":
            x_qm_scale += 1
        else:
            epf_iters = 2 if epf_iters != 2 else 1
        return real(writer, x_qm_scale, epf_iters)

    return write


@pytest.mark.parametrize("field", ["global_scale", "quant_dc", "x_qm_scale", "epf_iters"])
def test_a_header_field_altered_in_assembly_is_not_correct(monkeypatch, field):
    """The groups as the program made them, one field of the header that
    assembly writes off by one step: every pixel decodes otherwise."""
    from jxl_tiny_tpu_torch.bitstream import sections

    if field in ("global_scale", "quant_dc"):
        monkeypatch.setattr(sections, "write_quant_scales",
                            _write_quant_scales_off(sections.write_quant_scales, field))
    else:
        monkeypatch.setattr(sections, "write_frame_header",
                            _write_frame_header_off(sections.write_frame_header, field))
    r = H.run(H.small_cell("u8.single"), seed=24)
    assert not r["correct"]
    assert r["check"]["header_off"]["value"] > 0
    assert r["check"]["values_off"]["value"] == 0


def test_half_of_a_batch_left_out_is_not_correct():
    from jxl_tiny_tpu_torch import encoder

    def half(imgs, distance):
        out = encoder.encode_batch_device(imgs[: len(imgs) // 2], distance, device="cpu")
        return out + out[: len(imgs) - len(out)]

    r = H.run(H.small_cell("u8.batch64", tile=512, batch=4, answers=1),
              H.cpu_encoder(encode_batch_device=half), seed=23)
    assert not r["correct"]
    assert r["check"]["inputs_share_bytes"]["value"] > 0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_cell_on_the_card_is_correct(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "photo8mp-d1.u8.single", "--seed", "4000000007", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, cwd=H.ROOT,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], out.stderr[-4000:]
    assert r["device"]["kind"].startswith("NVIDIA")


def test_pool_reference_pixels_follow_the_stated_upload():
    cfg = dict(name="g", generator="photo_variants", image="testdata/gradient512.pfm",
               width=512, height=512, tile=None, distance=1.0,
               variants=dict(orientations=["none"], gains=[1.0], gain_jitter=0))
    pool = make_pool(H.ROOT, cfg, dict(pixels="f32"), 1)
    img = pool.requests[0][0]
    np.testing.assert_array_equal(pool.reference_pixels(img), img)


def test_one_value_off_a_tie_is_counted_and_one_at_a_tie_is_not():
    from jxlbench.check import _ac_mask, differences
    from jxlbench.reference.common import compute_distance_params

    img = read_pfm(os.path.join(H.ROOT, "testdata", "photo8mp.pfm"))[:, :256, :256]
    ref = golden.analyze_group(np.ascontiguousarray(img), 32, 32, compute_distance_params(1.0))
    assert differences(ref, ref["quantized"], ref)["values_off"] == 0
    mask = np.zeros_like(ref["tie_ac"])
    mask[1] = _ac_mask()[ref["strategy"].astype(int)] & ref["is_first"][..., None]  # Y's AC
    for tie in (False, True):
        where = np.argwhere(mask & (ref["tie_ac"] == tie))
        if not len(where):
            continue
        q = ref["quantized"].copy()
        q[tuple(where[0])] += 1
        out = differences(ref, q, ref)
        assert (out["values_off"], out["at_ties"]) == ((0, 1) if tie else (1, 0))
    dec = dict(ref, strategy=ref["strategy"].copy())
    dec["strategy"][0, 0] = 3 - dec["strategy"][0, 0] if dec["strategy"][0, 0] else 0
    dec["raw_qf"] = ref["raw_qf"] + (np.arange(ref["raw_qf"].size).reshape(32, 32) == 5)
    assert differences(dec, ref["quantized"], ref)["blocks_off"] >= 1
