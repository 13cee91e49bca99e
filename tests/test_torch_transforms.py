"""PyTorch port: word transforms held bit-exactly against the JAX package
(``ops/jax_transforms.py``) and the numpy golden model (``byte_group``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zipnn_tpu.ops import byte_group, jax_transforms
from zipnn_tpu_torch.ops import transforms

RNG = np.random.default_rng(1234)


def _t(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words_u32.view(np.int32).copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _edge_words(n: int) -> np.ndarray:
    w = RNG.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[:6] = [0, 0xFFFFFFFF, 0x80008000, 0x7FFF7FFF, 0x00800080, 0x80000001]
    return w


@pytest.mark.parametrize("fn", ["reorder_sign_16", "revert_sign_16", "reorder_sign_32",
                                "revert_sign_32"])
def test_sign_rotation_matches_jax_and_numpy(fn):
    w = _edge_words(4099)
    got = _np(getattr(transforms, fn)(_t(w)))
    want_jax = np.asarray(getattr(jax_transforms, fn)(jnp.asarray(w)))
    want_np = getattr(byte_group, fn)(w.view(np.uint8)).view(np.uint32)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)


def test_sign_rotation_roundtrip():
    w = _edge_words(1000)
    back = transforms.revert_sign_16(transforms.reorder_sign_16(_t(w)))
    np.testing.assert_array_equal(_np(back), w)


@pytest.mark.parametrize("bit_reorder", [0, 1])
def test_combine_2_matches_jax_and_numpy(bit_reorder):
    planes = _edge_words(3 * 2 * 64).reshape(3, 2, 64)
    got = _np(transforms.combine_2(_t(planes), bit_reorder))
    want = np.asarray(jax_transforms.combine_2(jnp.asarray(planes), bit_reorder))
    np.testing.assert_array_equal(got, want)
    # and against the golden byte-level combine, chunk by chunk
    for c in range(3):
        pl = [planes[c, b].view(np.uint8) for b in range(2)]
        ref = byte_group.combine(pl, 512, 2, 10, bit_reorder)
        np.testing.assert_array_equal(got[c].view(np.uint8), ref)


@pytest.mark.parametrize("bit_reorder", [0, 1])
def test_combine_4_matches_jax_and_numpy(bit_reorder):
    planes = _edge_words(3 * 4 * 32).reshape(3, 4, 32)
    got = _np(transforms.combine_4(_t(planes), bit_reorder))
    want = np.asarray(jax_transforms.combine_device(jnp.asarray(planes), 4, 220, bit_reorder))
    np.testing.assert_array_equal(got, want)
    for c in range(3):
        pl = [planes[c, b].view(np.uint8) for b in range(4)]
        ref = byte_group.combine(pl, 512, 4, 220, bit_reorder)
        np.testing.assert_array_equal(got[c].view(np.uint8), ref)
