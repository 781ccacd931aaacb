"""The port's multi-image paths and its native host packer, on the CPU.

(a) batched program A (analyze_batch_packed) and batched program B
    (pack_batch_sections) against the JAX package's on two 96x128 images
    (the images of the JAX package's tests/test_utils.py): stream, totals,
    per-image histograms, DC layout, section words, bits and offsets equal
(b) encode_batch_device: bytes equal to the JAX package's encode_batch_device
    at the default tier; at the static tier and for u8 sRGB input, equal to
    the port's own per-image encodes
(c) the batch's building blocks against their one-image forms: per-image
    histograms, per-group code tables, batched group extraction and DC
    regrouping, per-image candidate picks
(d) encode_images_device: input order, bytes equal to encode_image_device,
    a job whose pack raises once is retried to the same bytes (also when
    the error comes from the opportunistic pack of a queued job), one that
    always raises propagates; the entry points raise without a card
(e) the native packer (cpp/pack.cc, built with g++ here): pack_bits equals
    the numpy packer on random items up to 56 bits and on empty writers,
    pack_tokens and histogram_tokens equal plain numpy versions, and the
    library's path is keyed by a hash of its source and flags
(f) the CLI's batch mode

Every output compared here is an integer or a byte string: all exact."""
import hashlib
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tiny_tpu.common import compute_distance_params
from jxl_tiny_tpu.encoder import encode_batch_device as jax_encode_batch
from jxl_tiny_tpu.entropy import entropy_write as JEW
from jxl_tiny_tpu.io import color as JCOLOR
from jxl_tiny_tpu.ops import dc_kernels as JDK
from jxl_tiny_tpu.ops import pipeline_jax as PJ
from jxl_tiny_tpu.ops.pack_kernels import ac_base64_map as jax_base64_map

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch import cli
from jxl_tiny_tpu_torch import constants as C
from jxl_tiny_tpu_torch.bitstream.bit_writer import BitWriter, pack_bits_numpy
from jxl_tiny_tpu_torch.common import EncoderConfig
from jxl_tiny_tpu_torch.cpp import build as NB
from jxl_tiny_tpu_torch.io import color as TCOLOR
from jxl_tiny_tpu_torch.ops import dc_kernels as DK
from jxl_tiny_tpu_torch.ops import pack_kernels as PK
from jxl_tiny_tpu_torch.ops import pipeline as PL
from jxl_tiny_tpu_torch.tables import numpy_tables, tables_from_numpy

TABLES = tables_from_numpy(numpy_tables(), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's CPU encodes: the suite runs
    several test processes on a few cores at once, and torch's own thread
    pool in each would oversubscribe them (an encode took ~50x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CAP = 32768
OW = 8192


def _img(seed=9, h=96, w=128):
    """The synthetic image of the JAX package's tests/test_utils.py."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.4 * np.sin(xx * 0.1),
            0.5 + 0.3 * np.cos(yy * 0.08),
            0.4 + 0.2 * np.sin((xx + yy) * 0.05),
        ]
    ).astype(np.float32)
    return np.clip(img + rng.randn(3, h, w).astype(np.float32) * 0.02, 0, 1)


IMGS = [_img(4), _img(5)]


def _single(img, config=None):
    return TE.encode_image_device(img, 1.0, upload_dtype=None, config=config, device="cpu")


def _i64(a):
    a = np.asarray(a)
    return a.view(np.int32).astype(np.int64) if a.dtype == np.uint32 else a.astype(np.int64)


def _wcap(n, ow):  # the encoder's section buffer size rule
    return min(1 << int(n * ow).bit_length(), 2 * 1024 * 1024)


@pytest.fixture(scope="module")
def jax_batch():
    """The JAX package's batch encode, its program A and program B (fed its
    own program A and per-image code tables) on IMGS."""
    data = jax_encode_batch(IMGS, 1.0, upload_dtype=None)
    distp = compute_distance_params(1.0)
    batch = np.stack(IMGS)
    yb, xb = (v.numpy() for v in PL.group_valid_blocks(96, 128, "cpu", n_images=2))
    a = PJ.analyze_batch_packed(
        jnp.asarray(batch), jnp.asarray(yb), jnp.asarray(xb),
        distance=float(distp.distance), inv_scale=float(distp.inv_scale),
        scale=float(distp.scale), scale_dc=float(distp.scale_dc),
        x_qm_mul=float(distp.x_qm_mul), cfl=True, blocks=True, cap=CAP,
    )
    a = {k: np.asarray(v) for k, v in a.items()}
    base_map = jax_base64_map()
    d_ac = np.stack([JEW.build_ac_device_code(h[0], base_map)[1] for h in a["hists"]])
    d_dc = np.stack([JEW.build_dc_device_code(h[1][: C.NUM_DC_CONTEXTS])[1]
                     for h in a["hists"]]).astype(np.float32)
    d_ac = d_ac.astype(np.float32)
    ng, ngd = len(yb), a["dc_layout"].shape[0]
    sizes = dict(ow_ac=OW, wcap_ac=_wcap(ng, OW), ow_dc=OW, wcap_dc=_wcap(ngd, OW))
    b = JDK.pack_batch_sections(
        jnp.asarray(a["stream"][:, :CAP]), jnp.asarray(a["totals"]), jnp.asarray(d_ac),
        jnp.asarray(a["dc_layout"]), jnp.asarray(d_dc), **sizes,
    )
    b = {k: np.asarray(v) for k, v in b.items()}
    return dict(data=data, a=a, b=b, d_ac=d_ac, d_dc=d_dc, sizes=sizes)


@pytest.fixture(scope="module")
def port_a():
    distp = compute_distance_params(1.0)
    yb, xb = PL.group_valid_blocks(96, 128, "cpu", n_images=2)
    return PL.analyze_batch_packed(
        torch.from_numpy(np.stack(IMGS)), yb, xb, distp, CAP, TABLES,
    )


# -- (a) batched programs against the JAX package ---------------------------


@pytest.mark.parametrize("key", ["stream", "totals", "hists", "dc_layout"])
def test_analyze_batch_packed_matches_jax(jax_batch, port_a, key):
    want, got = jax_batch["a"][key], port_a[key].numpy()
    assert got.shape == want.shape, key
    assert np.array_equal(_i64(got), _i64(want)), key


def test_batch_hists_are_per_image(port_a):
    """Each image's histograms count only its own tokens: [N, 2, 64, 64]
    with the per-image totals' sum of AC tokens."""
    h, totals = port_a["hists"].numpy(), port_a["totals"].numpy()
    assert h.shape == (2, 2, 64, 64)
    for k in range(2):
        assert h[k, 0].sum() == totals[k]  # one group an image


@pytest.mark.parametrize("key", ["ac_words", "ac_bits", "ac_offs", "dc_words",
                                 "dc_bits", "dc_offs", "small"])
def test_pack_batch_sections_matches_jax(jax_batch, key):
    a = jax_batch["a"]
    got = DK.pack_batch_sections(
        torch.from_numpy(a["stream"][:, :CAP].view(np.int32).copy()),
        torch.from_numpy(a["totals"].astype(np.int64)),
        torch.from_numpy(jax_batch["d_ac"]),
        torch.from_numpy(a["dc_layout"].view(np.int32).copy()),
        torch.from_numpy(jax_batch["d_dc"]), **jax_batch["sizes"],
    )[key].numpy()
    want = jax_batch["b"][key]
    assert got.shape == want.shape, key
    assert np.array_equal(_i64(got), _i64(want)), key


# -- (b) whole batch encodes -------------------------------------------------


def test_encode_batch_matches_jax(jax_batch):
    got = TE.encode_batch_device(IMGS, 1.0, upload_dtype=None, device="cpu")
    assert got == jax_batch["data"]
    assert got == [_single(im) for im in IMGS]


def test_encode_batch_static_matches_singles():
    cfg = EncoderConfig(optimize_code=False)
    got = TE.encode_batch_device(IMGS, 1.0, upload_dtype=None, config=cfg, device="cpu")
    assert got == [_single(im, cfg) for im in IMGS]


def test_encode_batch_u8_matches_singles():
    u8 = [TCOLOR.linear_to_srgb_u8(im) for im in IMGS]
    got = TE.encode_batch_device(u8, 1.0, device="cpu")
    assert got == [TE.encode_image_device(im, 1.0, device="cpu") for im in u8]


def test_encode_batch_retries_match_singles():
    """A token cap and section budget that the batch overflows: the batch
    re-runs at the next buckets and gives the same bytes."""
    got = TE.encode_batch_device(IMGS, 1.0, upload_dtype=None, cap=1024, ow=256,
                                 device="cpu")
    assert got == [_single(im) for im in IMGS]


def test_encode_batch_rejects_mixed_shapes():
    with pytest.raises(TE.InvalidInputError):
        TE.encode_batch_device([IMGS[0], IMGS[1][:, :64]], 1.0, device="cpu")


@pytest.mark.parametrize("fn", ["linear_to_srgb_u8", "srgb_u8_to_linear"])
def test_color_helpers_match_jax(fn):
    rng = np.random.RandomState(3)
    x = (rng.rand(3, 17, 23).astype(np.float32) * 1.2 - 0.1 if fn == "linear_to_srgb_u8"
         else rng.randint(0, 256, (3, 17, 23)).astype(np.uint8))
    got, want = getattr(TCOLOR, fn)(x), getattr(JCOLOR, fn)(x)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- (c) building blocks against their one-image forms ------------------------


def test_hist_base64_per_image_equals_single_calls(port_a):
    s, t = port_a["stream"][:, :CAP], torch.clamp_max(port_a["totals"], CAP)
    both = PK.hist_base64(s, t, n_images=2)
    for k in range(2):
        assert torch.equal(both[k], PK.hist_base64(s[k:k + 1], t[k:k + 1])[0])


def test_dc_hist_per_image_equals_single_calls(port_a):
    layout = port_a["dc_layout"]
    both = DK.dc_hist(layout, n_images=2)
    for k in range(2):
        assert torch.equal(both[k], DK.dc_hist(layout[k:k + 1])[0])


def test_table_lookup_per_group_equals_shared_tables():
    rng = np.random.RandomState(7)
    tables = []
    for _ in range(3):
        d = np.zeros((9, 64), np.float32)
        d[0] = rng.randint(0, 8, 64)
        d[1:] = rng.randint(0, 1 << 20, (8, 64))
        tables.append(d)
    base = torch.from_numpy(rng.randint(0, 64, (3, 500)))
    tok = torch.from_numpy(rng.randint(0, 64, (3, 500)))
    got = PK.table_lookup(base, tok, torch.from_numpy(np.stack(tables)))
    for g in range(3):
        want = PK.table_lookup(base[g:g + 1], tok[g:g + 1], torch.from_numpy(tables[g]))
        assert torch.equal(got[g:g + 1], want)


def test_extract_groups_batched_equals_per_image():
    rng = np.random.RandomState(2)
    imgs = torch.from_numpy(rng.randint(0, 256, (2, 3, 300, 270)).astype(np.uint8))
    got = PL.extract_groups_device(imgs)
    want = torch.cat([PL.extract_groups_device(im) for im in imgs])
    assert torch.equal(got, want)


@pytest.mark.parametrize("trailing", [False, True])
def test_regroup_dc_batched_equals_per_image(trailing):
    rng = np.random.RandomState(4)
    g = 8 * 16  # a padded grid of 8 x 16 groups an image
    shape = (2 * g, 3, 4, 4) if trailing else (2 * g, 4, 4)
    maps = torch.from_numpy(rng.randint(-99, 99, shape))
    got = DK.regroup_dc(maps, 8, 16, trailing, n_images=2)
    want = torch.cat([DK.regroup_dc(m, 8, 16, trailing) for m in maps.split(g)])
    assert torch.equal(got, want)


def test_select_code_table_per_image_equals_single_picks():
    rng = np.random.RandomState(6)
    hists = torch.from_numpy(rng.randint(0, 1000, (4, 64, 64)))
    depths = torch.from_numpy(rng.randint(1, 15, (5, 64, 64)).astype(np.int32))
    depths[3] = depths[1]  # a tie: the lowest index wins
    picks = DK.select_code_table(hists, depths)
    assert picks.tolist() == [int(DK.select_code_table(h, depths)) for h in hists]


# -- (d) the pipelined entry point ---------------------------------------------


PIPE_IMGS = [_img(1), _img(2, w=112), _img(3, w=96)]  # widths tell the jobs apart


@pytest.fixture(scope="module")
def pipe_singles():
    return [_single(im) for im in PIPE_IMGS]


def _pipeline(depth=3, retries=1):
    return list(TE.encode_images_device(PIPE_IMGS, 1.0, upload_dtype=None, depth=depth,
                                        retries=retries, device="cpu"))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_encode_images_in_order_and_equal_to_singles(pipe_singles, depth):
    before = TE.RETRY_COUNT
    assert _pipeline(depth) == pipe_singles
    assert TE.RETRY_COUNT == before


def _failing_pack(monkeypatch, width, times):
    """Make pack() of the job of the image of this width raise `times`
    times (None: always)."""
    real = TE.DeviceEncodeJob.pack
    calls = {"failed": 0}

    def pack(job):
        if job.dim.xsize == width and not job._packed and (
                times is None or calls["failed"] < times):
            calls["failed"] += 1
            raise RuntimeError("injected pack failure")
        return real(job)

    monkeypatch.setattr(TE.DeviceEncodeJob, "pack", pack)
    return calls


@pytest.mark.parametrize("depth", [1, 2])
def test_encode_images_retries_a_failed_pack(monkeypatch, pipe_singles, depth):
    """depth 1: the pack in finish() raises; depth 2: the opportunistic
    pack of the queued job raises, and the error is not lost."""
    calls = _failing_pack(monkeypatch, 112, 1)
    before = TE.RETRY_COUNT
    assert _pipeline(depth) == pipe_singles
    assert calls["failed"] == 1 and TE.RETRY_COUNT == before + 1


@pytest.mark.parametrize("depth", [1, 2])
def test_encode_images_propagates_a_lasting_failure(monkeypatch, depth):
    calls = _failing_pack(monkeypatch, 112, None)
    gen = TE.encode_images_device(PIPE_IMGS, 1.0, upload_dtype=None, depth=depth,
                                  retries=1, device="cpu")
    assert len(next(gen)) > 0
    with pytest.raises(RuntimeError, match="injected"):
        next(gen)
    assert calls["failed"] == 2  # the first attempt and its one retry


def test_encode_images_without_retries_raises_the_queued_error(monkeypatch):
    """An error kept from the opportunistic pack is raised by finish() when
    no retry is left."""
    _failing_pack(monkeypatch, 112, 1)
    with pytest.raises(RuntimeError, match="injected"):
        _pipeline(depth=2, retries=0)


def test_failed_pack_leaves_the_job_unpacked(monkeypatch):
    job = TE.DeviceEncodeJob([IMGS[0]], 1.0, upload_dtype=None, device="cpu")
    assert job.ready_for_pack()

    def broken(*args):
        raise ValueError("no code")

    monkeypatch.setattr(TE, "build_ac_device_code", broken)
    with pytest.raises(ValueError):
        job.pack()
    assert not job._packed
    monkeypatch.undo()
    job.pack()
    assert job._packed and job.result() == [_single(IMGS[0])]


def test_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.encode_batch_device(IMGS, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.encode_images_device(IMGS, 1.0)  # at the call, before any image


# -- (e) the native packer -----------------------------------------------------


def _random_items(seed, n, max_bits=56):
    rng = np.random.RandomState(seed)
    nbits = rng.randint(0, max_bits + 1, n).astype(np.uint8)
    hi = rng.randint(0, 1 << 31, n).astype(np.uint64) << np.uint64(32)
    lo = rng.randint(0, 1 << 31, n).astype(np.uint64) << np.uint64(1)
    values = (hi | lo | np.uint64(1)) & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1))
    return nbits, values


def test_native_packer_builds_here():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the numpy packer runs instead")
    assert NB.native_packer() is not None


@pytest.mark.parametrize("case", ["random", "all_56_bits", "all_zero_width", "one_item",
                                  "single_bits"])
def test_native_pack_bits_matches_numpy(case):
    if case == "random":
        nbits, values = _random_items(0, 20000)
    elif case == "all_56_bits":
        nbits = np.full(777, 56, np.uint8)
        values = np.full(777, (1 << 56) - 1, np.uint64)
    elif case == "all_zero_width":
        nbits, values = np.zeros(50, np.uint8), np.zeros(50, np.uint64)
    elif case == "one_item":
        nbits, values = np.array([13], np.uint8), np.array([0x1ABC], np.uint64)
    else:
        nbits, values = _random_items(1, 4097, max_bits=1)
    assert NB.pack_bits(nbits, values) == pack_bits_numpy(nbits, values)


def test_bit_writer_with_native_packer_equals_numpy():
    """to_bytes over writers of mixed items, appended writers and empty
    writers equals the numpy packer on the same items."""
    w, parts = BitWriter(), []
    for seed in range(5):
        nb, v = _random_items(10 + seed, 300 * seed)
        inner = BitWriter()
        inner.write_arrays(nb, v)
        w.append_writer(inner)
        w.append_writer(BitWriter())  # empty
        w.write(7, 0x55)
        parts.append((nb, v))
        parts.append((np.array([7], np.uint8), np.array([0x55], np.uint64)))
    nbits = np.concatenate([p[0] for p in parts])
    values = np.concatenate([p[1] for p in parts])
    assert w.to_bytes() == pack_bits_numpy(nbits, values)
    assert BitWriter().to_bytes() == b""


def test_native_pack_tokens_matches_plain():
    rng = np.random.RandomState(5)
    n_ctx, n_cl = 9, 3
    ctx_map = rng.randint(0, n_cl, n_ctx).astype(np.uint8)
    depths = rng.randint(1, 16, (n_cl, 64)).astype(np.uint8)
    bits = (rng.randint(0, 1 << 15, (n_cl, 64)) & ((1 << depths.astype(np.int64)) - 1))
    bits = bits.astype(np.uint16)
    values = np.concatenate([rng.randint(0, 16, 500), rng.randint(16, 1 << 16, 500)])
    stream = ((rng.randint(0, n_ctx, 1000) << 16) | values).astype(np.uint32)
    data, total = NB.pack_tokens(stream, ctx_map, depths, bits)
    items = []  # (nbits, value): the code, then the hybrid-uint extra bits
    for word in stream.tolist():
        ctx, v = word >> 16, word & 0xFFFF
        nlog = v.bit_length() - 1
        tok, nb2 = (v, 0) if v < 16 else ((nlog << 2) + ((v >> (nlog - 2)) & 3), nlog - 2)
        cl = int(ctx_map[ctx])
        items += [(int(depths[cl, tok]), int(bits[cl, tok])), (nb2, v & ((1 << nb2) - 1))]
    nb, val = (np.array(c, dtype) for c, dtype in zip(zip(*items), (np.uint8, np.uint64)))
    assert total == int(nb.sum())
    assert data == pack_bits_numpy(nb, val)


def test_native_histogram_tokens_matches_plain():
    rng = np.random.RandomState(8)
    values = np.concatenate([rng.randint(0, 16, 700), rng.randint(16, 1 << 16, 700)])
    stream = ((rng.randint(0, 5, 1400) << 16) | values).astype(np.uint32)
    tok, _, _ = PK.uint_token_extra(torch.from_numpy(values.astype(np.int64)))
    want = np.zeros((5, 64), np.int64)
    np.add.at(want, ((stream >> 16).astype(np.int64), tok.numpy()), 1)
    assert np.array_equal(NB.histogram_tokens(stream, 5), want)


def test_native_library_is_keyed_by_its_source():
    """The library's directory is named by a hash of pack.cc and the flags,
    so an edited source can never load an older binary."""
    h = hashlib.sha256(" ".join(NB.CXX_FLAGS).encode())
    h.update(NB.SOURCE.read_bytes())
    path = NB.library_path()
    assert path.parent.name == f"cpp-{h.hexdigest()[:16]}"
    if NB.native_packer() is not None:
        assert NB.native_packer()._name == str(path)


# -- (f) the CLI ----------------------------------------------------------------


def test_cli_batch_mode(testdata, tmp_path):
    names = ["tiny64", "odd131x77"]
    srcs = [os.path.join(testdata, f"{n}.pfm") for n in names]
    assert cli.main(srcs + [str(tmp_path), "--device", "cpu", "-q"]) == 0
    for name, size in zip(names, (394, 1061)):  # the default tier's sizes
        assert len((tmp_path / f"{name}.jxl").read_bytes()) == size
    assert cli.main(srcs + [str(tmp_path / "missing"), "--device", "cpu", "-q"]) == 1
