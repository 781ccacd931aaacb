"""The port's mesh programs against the JAX package's, on the CPU.

(b) 4 port ranks (gloo, spawned by the package's launcher) run image-level
    program A (analyze_image_packed_mesh) and program B
    (pack_all_sections_mesh) on the 300x700 image of the JAX package's
    tests/test_sharding.py: 6 groups padded to 8, one DC group padded to 4.
    Each rank's stream, totals, summed histograms and DC layout rows
    (padding rows included), and the global totals and section sizes
    (`small`), equal the same slices of the JAX package's programs on a
    4-device CPU mesh
(c) the 4-rank mesh encode of that image (default tier, float) equals the
    JAX package's encode_image_device

Every comparison is of integers or bytes: exact. The JAX programs compile
here (about a minute on one core), so this file holds only these two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tiny_tpu.common import compute_distance_params
from jxl_tiny_tpu.encoder import encode_image_device as jax_encode
from jxl_tiny_tpu.entropy import entropy_write as JEW
from jxl_tiny_tpu.ops.pack_kernels import ac_base64_map as jax_base64_map
from jxl_tiny_tpu.parallel import sharding as JSH

from jxl_tiny_tpu_torch import constants as C
from jxl_tiny_tpu_torch.parallel import sharding as SH
from jxl_tiny_tpu_torch.tools import multihost_dryrun as MD

IMG = MD.synthetic_image()
N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Rank r's program outputs (rank<r>.npz) and rank 0's encode."""
    out = tmp_path_factory.mktemp("mesh_jax")
    MD.launch(N, MD.run_tasks, ([
        (MD.program_outputs, (IMG, str(out))),
        (MD.encode_cases, ([dict(name="default", image=IMG, kwargs=dict(upload_dtype=None))],
                           str(out))),
    ],), timeout_s=300)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(N)], (out / "default.bin").read_bytes()


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} JAX CPU devices")
    mesh = JSH.make_mesh(jax.devices()[:N])
    distp = compute_distance_params(1.0)
    yb, xb = (v.numpy() for v in SH.padded_valid_blocks(300, 700, N, "cpu"))
    a = JSH.analyze_image_packed_mesh(jnp.asarray(IMG), jnp.asarray(yb), jnp.asarray(xb),
                                      distp, mesh, cap=32768, ysize=300, xsize=700)
    hists = np.asarray(a["hists"])
    _, d_ac = JEW.build_ac_device_code(hists[0], jax_base64_map())
    _, d_dc = JEW.build_dc_device_code(hists[1][: C.NUM_DC_CONTEXTS])
    b = JSH.pack_all_sections_mesh(a["stream"][:, :32768], a["totals"], d_ac,
                                   a["dc_layout"], d_dc, mesh, ow_ac=8192, ow_dc=8192)
    out = {k: np.asarray(v) for k, v in a.items()}
    out["small"] = np.asarray(b["small"])
    return out


def _i64(a):
    """Integer arrays of either package as int64 (uint32 bit patterns as
    the int32 the port holds)."""
    a = np.asarray(a)
    return a.view(np.int32).astype(np.int64) if a.dtype == np.uint32 else a.astype(np.int64)


@pytest.mark.parametrize("rank", range(N))
@pytest.mark.parametrize("key", ["stream", "totals", "dc_layout"])
def test_rank_blocks_match_jax(port, jax_mesh, key, rank):
    got = port[0][rank][key]
    n = got.shape[0]
    assert np.array_equal(_i64(got), _i64(jax_mesh[key][rank * n: (rank + 1) * n]))


@pytest.mark.parametrize("key,jkey", [("hists", "hists"), ("all_totals", "totals"),
                                      ("small", "small")])
def test_replicated_outputs_match_jax(port, jax_mesh, key, jkey):
    want = _i64(jax_mesh[jkey]).reshape(-1)
    for rank in range(N):
        assert np.array_equal(_i64(port[0][rank][key]).reshape(-1), want)


def test_mesh_encode_matches_jax_encode(port):
    assert port[1] == jax_encode(IMG, 1.0, upload_dtype=None)
