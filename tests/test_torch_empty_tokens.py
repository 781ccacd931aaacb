"""AC tokens that take no bits, on the CPU.

A base cluster whose histogram holds a single token gets a prefix code of
one symbol, and JPEG XL codes that symbol with no bits. Such empty tokens
then sit inside a group's AC token stream. The JAX package's word packer
(`bitpack_groups_words` with prefix_valid=True) assumes that the tokens
with bits form one contiguous prefix, so its words lose bits, and the
codestream does not decode. The port moves the empty tokens out of the
scan's way (`pack_kernels.word_rows`).

(a) the word packer, with empty tokens inside the stream and runs of them
    longer than the scan's 63-token reach, equals the scatter-add
    reference (bitpack_groups_var_plain);
(b) a 384x256 corner of photo8mp at d=2.0, where the B channel's zero-
    nonzeros context holds only the token 0: the port's codestream decodes
    through both packages' decoders to the pixels of the port's
    host-packed stream (the same quantized image, full-context codes); the
    JAX package's stream of the same image has the same length and raises
    DecodeError in both decoders."""
import os

import numpy as np
import pytest
import torch

from jxl_tiny_tpu.decode.decoder import decode_jxl as j_decode
from jxl_tiny_tpu.encoder import encode_image_device as jax_encode
from jxl_tiny_tpu.errors import DecodeError as JDecodeError

import jxl_tiny_tpu_torch.encoder as TE
from jxl_tiny_tpu_torch.decode import decode_jxl
from jxl_tiny_tpu_torch.errors import DecodeError
from jxl_tiny_tpu_torch.io.pfm import read_pfm
from jxl_tiny_tpu_torch.ops import pack_kernels as PK

PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "testdata",
                     "photo8mp.pfm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed, g=3, cap=1024, n=700, empty=0.4, run=(200, 300)):
    """A token stream of n tokens a group (then an empty tail), a share of
    them empty and one run of empty tokens at `run`; widths 1-14 bits."""
    rng = np.random.RandomState(seed)
    nbits = rng.randint(1, 15, size=(g, cap)).astype(np.int64)
    nbits[rng.rand(g, cap) < empty] = 0
    nbits[:, run[0]:run[1]] = 0
    nbits[:, n:] = 0
    data = rng.randint(0, 1 << 14, size=(g, cap)).astype(np.int64) & ((1 << nbits) - 1)
    pos = np.cumsum(nbits, axis=1) - nbits
    return tuple(torch.from_numpy(a) for a in (data, nbits, pos))


@pytest.mark.parametrize("seed", [0, 1])
def test_word_packer_with_empty_tokens(seed):
    data, nbits, pos = _tokens(seed)
    ow = 1024
    want = PK.bitpack_groups_var_plain(data, nbits, pos, ow)
    assert torch.equal(PK.bitpack_groups_words(data, nbits, pos, ow), want)


@pytest.fixture(scope="module")
def corner():
    return np.ascontiguousarray(read_pfm(PHOTO)[:, :256, :384])


def test_single_symbol_cluster_decodes(corner):
    got = TE.encode_image_device(corner, 2.0, device="cpu")
    want = jax_encode(corner, 2.0)
    assert len(got) == len(want) and got != want
    for decode, error in ((decode_jxl, DecodeError), (j_decode, JDecodeError)):
        with pytest.raises(error):
            decode(want)
    pixels = decode_jxl(got)
    assert np.array_equal(j_decode(got), pixels)
    host = TE.encode_image_host_packed(corner, 2.0, device="cpu")
    assert np.array_equal(decode_jxl(host), pixels)
