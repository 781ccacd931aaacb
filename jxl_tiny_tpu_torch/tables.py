"""The encoder's constant tables as one torch module.

This encoder has no learned weights: its "parameters" are the fixed tables
the device stages read (quant/dequant/threshold matrices per strategy, scan
orders, context tables, the DCT matrix and the DCT16 half matrices, the
strategy search's quant weights, the DC gradient-context steps).
`numpy_tables()` builds them from the port's own constants; the tests build
the same dict from the JAX package's module attributes and compare.

`device_tables(device)` builds them once a device and shares them across
jobs. Every upload here (`to_device`) goes through pinned memory with
`non_blocking=True`, so building tables on the card never waits for work
already queued there.
"""
import functools

import numpy as np
import torch
from torch import nn

from . import constants as C
from .ref.dct_np import dct16_half_mats, dct_matrix
from .ref.group_np import threshold_map


def _strategy_tables():
    qm = np.zeros((3, 3, 128), np.float32)  # [strategy, channel, coeff]
    dqm = np.zeros((3, 3, 128), np.float32)
    thr = np.zeros((3, 3, 128), np.float32)
    qm[C.DCT8, :, :64] = C.QUANT_DCT8.reshape(3, 64)
    dqm[C.DCT8, :, :64] = C.DEQUANT_DCT8.reshape(3, 64)
    qm[C.DCT16X8] = qm[C.DCT8X16] = C.QUANT_DCT16.reshape(3, 128)
    dqm[C.DCT16X8] = dqm[C.DCT8X16] = C.DEQUANT_DCT16.reshape(3, 128)
    for c in range(3):
        thr[C.DCT8, c, :64] = threshold_map(c, 1, 1).ravel()
        thr[C.DCT16X8, c] = threshold_map(c, 1, 2).ravel()
        thr[C.DCT8X16, c] = threshold_map(c, 2, 1).ravel()
    order = np.zeros((3, 128), np.int32)
    order[C.DCT8] = np.concatenate([C.COEFF_ORDER8, 64 + np.arange(64)])
    order[C.DCT16X8] = order[C.DCT8X16] = C.COEFF_ORDER16
    return qm, dqm, thr, order


def zigzag_tables(qm, dqm, thr, order):
    """The quantizer's tables as csrc/quantize.cu reads them.

    Lane l of a warp owns zig-zag positions 4l..4l+3 of a cell, so it wants
    its table entries side by side: qm_zz, thr_zz [3,3,128] and dqm_zz
    [3,128] (Y only) are qm / thr / dqm read through the order table
    (`t_zz[s, c, j] = t[s, c, order[s, j]]`), and order_zz [3,32] i32 packs
    the four natural indices of a lane, position 4l+e in byte e. dc_pos[s]
    = the zig-zag positions of natural coefficients 0 and 1 (the DC pair's
    inputs), plain host ints."""
    order = np.asarray(order, np.int64)
    s_idx = np.arange(3)[:, None, None]
    c_idx = np.arange(3)[None, :, None]
    idx = order[:, None, :]
    q = order.reshape(3, 32, 4)
    words = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    dc_pos = tuple(
        tuple(int(np.flatnonzero(order[s] == k)[0]) for k in (0, 1)) for s in range(3)
    )
    return dict(
        qm_zz=np.ascontiguousarray(np.asarray(qm)[s_idx, c_idx, idx]),
        thr_zz=np.ascontiguousarray(np.asarray(thr)[s_idx, c_idx, idx]),
        dqm_zz=np.ascontiguousarray(np.asarray(dqm)[np.arange(3)[:, None], 1, order]),
        order_zz=words.astype(np.int32),
    ), dc_pos


def _nnz_ctx_steps():
    """COEFF_NNZ_CTX as a monotone step function (thresholds, deltas)."""
    lut = C.COEFF_NNZ_CTX.astype(np.int64).copy()
    lut[0] = 0  # index 0 is never used (guarded by nzeros_left > 0)
    deltas = np.diff(lut)
    idx = np.nonzero(deltas)[0] + 1
    return idx.astype(np.int32), deltas[idx - 1].astype(np.int32)


def _grad_step_tables():
    """GRADIENT_CTX_LUT (enc_frame.cc:224-285) as two step functions of the
    clamped gradient distance: ctx = base + the deltas of every threshold
    the distance reaches."""
    lut = C.GRADIENT_CTX_LUT.astype(np.int64)

    def steps(side):  # side=+1: lut[512+d], side=-1: lut[512-d]
        vals = [int(lut[512 + side * d]) for d in range(0, 512)]
        ths, dls = [], []
        for d in range(1, 512):
            if vals[d] != vals[d - 1]:
                ths.append(d)
                dls.append(vals[d] - vals[d - 1])
        return np.array(ths, np.int32), np.array(dls, np.int32), vals[0]

    return steps(+1), steps(-1)


def numpy_tables() -> dict:
    """All tables as numpy arrays, keyed by buffer name."""
    qm, dqm, thr, order = _strategy_tables()
    nnz_thresh, nnz_delta = _nnz_ctx_steps()
    (pos_t, pos_d, base0), (neg_t, neg_d, _) = _grad_step_tables()
    a0, a1 = dct16_half_mats()
    return dict(
        qm_tab=qm,
        dqm_tab=dqm,
        thr_tab=thr,
        order_tab=order,
        # Zig-zag scans as index permutations: ordered[j] = natural[perm[j]].
        zz_perm8=np.concatenate([C.COEFF_ORDER8, 64 + np.arange(64)]).astype(
            np.int32
        ),
        zz_perm16=np.asarray(C.COEFF_ORDER16, np.int32),
        freq_tab=np.stack(
            [
                C.COEFF_FREQ_CTX[np.clip(np.arange(128) >> 0, 0, 63)],
                C.COEFF_FREQ_CTX[np.clip(np.arange(128) >> 1, 0, 63)],
            ]
        ).astype(np.int32),  # [covered-1, 128]
        nnz_thresh=nnz_thresh,
        nnz_delta=nnz_delta,
        block_ctx_tab=np.stack(
            [C.BLOCK_CTX_MAP[c, C.STRATEGY_CODE] for c in range(3)], axis=1
        ).astype(np.int32),  # [strategy, channel]
        dct8=dct_matrix(8),
        dct16_a0=a0,
        dct16_a1=a1,
        # Quant weights of the AC-strategy search, per channel.
        qm8=C.QUANT_DCT8.reshape(3, 64),
        qm16=C.QUANT_DCT16.reshape(3, 128),
        grad_pos_t=pos_t,
        grad_pos_d=pos_d,
        grad_neg_t=neg_t,
        grad_neg_d=neg_d,
        grad_base=np.array([base0], np.int32),
    )


def to_device(t, device) -> torch.Tensor:
    """Host tensor or array -> tensor on `device`. For the card the copy is
    queued from pinned memory with non_blocking=True: it neither waits for
    the work already queued nor lets the host buffer be reused before the
    copy has run (the pinned allocator records the copy's stream)."""
    t = torch.as_tensor(t)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class EncoderTables(nn.Module):
    """Constant tables as buffers, on one device. Plain host ints that the
    stages need before any launch are kept as attributes, so reading them
    never waits on the device."""

    def __init__(self, arrays: dict):
        super().__init__()
        for name, arr in arrays.items():
            self.register_buffer(name, torch.from_numpy(np.array(arr)))
        # The two raw header entries that open every DC-section layout.
        self.register_buffer("dc_header", torch.tensor(C.DC_HEADER, dtype=torch.int64))
        # Derived from the arrays given, so that they can never disagree.
        zz, self.dc_pos = zigzag_tables(
            arrays["qm_tab"], arrays["dqm_tab"], arrays["thr_tab"], arrays["order_tab"]
        )
        for name, arr in zz.items():
            self.register_buffer(name, torch.from_numpy(arr))
        self.nnz_thresh0 = int(arrays["nnz_thresh"][0])
        self.grad_base0 = int(arrays["grad_base"][0])
        # The tokenizer's one-threshold NNZ context shortcut requires every
        # step delta to exceed the base-64 q cap (ops.tokenize_kernel).
        if int(np.min(arrays["nnz_delta"])) <= 5:
            raise ValueError("NNZ deltas must saturate the q cap")

    @property
    def device(self):
        return self.qm_tab.device


def tables_from_numpy(arrays: dict, device) -> EncoderTables:
    tables = EncoderTables(arrays)
    for name, buf in list(tables.named_buffers()):
        setattr(tables, name, to_device(buf, device))
    return tables


def canonical_device(device) -> torch.device:
    """`cuda` -> `cuda:<current index>`, so that caches keyed by device
    see one key a card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _device_tables(device) -> EncoderTables:
    return tables_from_numpy(numpy_tables(), device)


def device_tables(device) -> EncoderTables:
    """The encoder's tables on `device`, built once and shared (read-only)."""
    return _device_tables(canonical_device(device))
