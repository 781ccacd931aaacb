"""The PyTorch port's constant tables and its independence from JAX.

The port keeps its own copies of the JAX package's tables; these tests hold
each copy against the JAX package's module attributes, and guard the rule
that the port imports neither jax nor jxl_tiny_tpu."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jxl_tiny_tpu.constants as JC
from jxl_tiny_tpu.ops import dc_kernels as JDK
from jxl_tiny_tpu.ops import pipeline_jax as PJ
from jxl_tiny_tpu.entropy import entropy_write as JEW
from jxl_tiny_tpu.ref.dct_np import dct16_half_mats, dct_matrix

import jxl_tiny_tpu_torch.constants as TC
from jxl_tiny_tpu_torch.bitstream import sections as TS
from jxl_tiny_tpu_torch.entropy import entropy_write as TEW
from jxl_tiny_tpu_torch.tables import EncoderTables, numpy_tables, tables_from_numpy

REPO = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(REPO, "jxl_tiny_tpu_torch")


def _perm_from_one_hot(p):
    """One-hot permutation matrix P (ordered = q @ P) -> index permutation."""
    assert (p.sum(axis=0) == 1).all() and (p.sum(axis=1) == 1).all()
    return np.argmax(p, axis=0).astype(np.int32)


def _jax_tables():
    """The same tables, built from the JAX package's module attributes."""
    return dict(
        qm_tab=PJ._QM_TAB,
        dqm_tab=PJ._DQM_TAB,
        thr_tab=PJ._THR_TAB,
        order_tab=PJ._ORDER_TAB,
        zz_perm8=_perm_from_one_hot(PJ._ZZ_P8),
        zz_perm16=_perm_from_one_hot(PJ._ZZ_P16),
        freq_tab=PJ._FREQ_TAB,
        nnz_thresh=PJ._NNZ_THRESH,
        nnz_delta=PJ._NNZ_DELTA,
        block_ctx_tab=PJ._BLOCK_CTX_TAB,
        dct8=dct_matrix(8),
        dct16_a0=dct16_half_mats()[0],
        dct16_a1=dct16_half_mats()[1],
        qm8=JC.QUANT_DCT8.reshape(3, 64),
        qm16=JC.QUANT_DCT16.reshape(3, 128),
        grad_pos_t=JDK._POS_T,
        grad_pos_d=JDK._POS_D,
        grad_neg_t=JDK._NEG_T,
        grad_neg_d=JDK._NEG_D,
        grad_base=np.array([JDK._BASE0], np.int32),
    )


def test_tables_match_jax_package():
    """tables_from_numpy over the port's own copies equals the tables built
    from the JAX package's attributes, buffer by buffer, bit for bit."""
    port = tables_from_numpy(numpy_tables(), "cpu")
    ref = tables_from_numpy(_jax_tables(), "cpu")
    names = dict(port.named_buffers())
    assert set(names) == set(dict(ref.named_buffers()))
    for name, buf in ref.named_buffers():
        got = names[name]
        assert got.dtype == buf.dtype, name
        assert torch.equal(got, buf), name
    assert port.nnz_thresh0 == ref.nnz_thresh0
    assert port.grad_base0 == ref.grad_base0


def test_zigzag_permutations_reproduce_one_hot_matrices():
    """The index permutations carry exactly the JAX package's one-hot
    zig-zag matrices (ordered[j] = natural[perm[j]])."""
    t = numpy_tables()
    for perm, p in ((t["zz_perm8"], PJ._ZZ_P8), (t["zz_perm16"], PJ._ZZ_P16)):
        one_hot = np.zeros((128, 128), np.float32)
        one_hot[perm, np.arange(128)] = 1.0
        assert np.array_equal(one_hot, p)
        q = np.random.RandomState(0).randint(-99, 99, size=128)
        assert np.array_equal(q[perm], (q @ p).astype(np.int64))


def test_gradient_step_tables_reproduce_lut():
    """The DC gradient step tables evaluate to GRADIENT_CTX_LUT."""
    from jxl_tiny_tpu_torch.ops.dc_kernels import gradient_ctx

    tabs = EncoderTables(numpy_tables())
    d = torch.arange(-600, 600)
    want = JC.GRADIENT_CTX_LUT[np.clip(d.numpy(), -512, 511) + 512]
    assert np.array_equal(gradient_ctx(d, tabs).numpy(), want)


@pytest.mark.parametrize(
    "name",
    sorted(n for n in dir(JC) if n.isupper() and not n.startswith("_")),
)
def test_constants_copy_matches(name):
    """Every public constant of the port's copy equals the JAX package's."""
    a, b = getattr(JC, name), getattr(TC, name)
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_static_codes_file_matches():
    """Every array of the port's own static_codes.npz equals the JAX
    package's."""
    a = np.load(os.path.join(os.path.dirname(JC.__file__), "static_codes.npz"))
    b = np.load(os.path.join(os.path.dirname(TC.__file__), "static_codes.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) >= 2
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("field", ["ac_tables", "ac_depths", "dc_tables", "dc_depths",
                                   "ac_codes", "dc_codes"])
def test_static_codes_match_jax_package(field):
    """load_static_codes: the candidate device tables, depth grids and
    serialized codes equal the JAX package's, candidate by candidate."""
    want, got = getattr(JEW.load_static_codes(), field), getattr(TEW.load_static_codes(), field)
    if not field.endswith("codes"):
        assert got.dtype == want.dtype and np.array_equal(got, want)
        return
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for attr in ("context_map", "depths", "bits", "token_depths"):
            assert np.array_equal(getattr(g, attr), getattr(w, attr)), attr


def test_dc_context_token_masks_match():
    from jxl_tiny_tpu.bitstream.sections import dc_context_token_masks

    assert np.array_equal(TS.dc_context_token_masks(), dc_context_token_masks())


def test_import_loads_no_jax():
    """Importing every module of the port loads no jax / jaxlib module and
    nothing of the JAX package (checked in a fresh interpreter)."""
    code = r"""
import importlib, pkgutil, sys
import jxl_tiny_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jxl_tiny_tpu"))
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("jxl_tiny_tpu_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|jxl_tiny_tpu)(?:\.|\s|$)", re.MULTILINE
)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_source_has_no_jax_imports():
    """No source file of the port, nor chip_smoke.py, imports jax or the JAX
    package (not even lazily inside a function)."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        offenders += [f"{path}: {m.group(0).strip()}" for m in _IMPORT_RE.finditer(src)]
    assert len(_port_sources()) > 20
    assert not offenders, offenders
