"""The port's device encode and host planners against the JAX package.

Tokens must be exactly equal to JAX ``encode_frames`` and to the literal
string oracle, on random bases with Ns, soft-masked bases and short
lengths, with masking on and off; the numpy planners must give the same
answers as the JAX module's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaeger_tpu.ops import encode as jenc
from jaeger_tpu.models.builder import mask_cut_plan as jax_mask_cut_plan
from jaeger_tpu.models.flagship import _inline_flagship
from jaeger_tpu_torch.models.builder import mask_cut_plan
from jaeger_tpu_torch.ops import encode as tenc

_CHARS = np.array(list("ATGCNatgc"))


def _bases(rng, n, cap, crop):
    """Base IDs 0-8 with runs of N and soft-masked bases, lengths that
    span short (< 5), partial and full windows."""
    bases = rng.integers(0, 4, size=(n, cap)).astype(np.uint8)
    for i in range(n):
        if i % 3 == 0:
            s = rng.integers(0, cap - 10)
            bases[i, s: s + rng.integers(1, 10)] = 4
        if i % 4 == 1:
            s = rng.integers(0, cap - 20)
            bases[i, s: s + 20] += 5
    bases[-1] = rng.integers(0, 9, size=cap)
    lengths = np.concatenate([
        [crop, cap, 3, 0, crop // 2 + 1, crop - 1],
        rng.integers(0, cap + 1, size=n - 6)]).astype(np.int32)
    return bases, lengths


@pytest.mark.parametrize("crop", [500, 166, 1505])
@pytest.mark.parametrize("masking", [False, True])
def test_encode_frames_matches_jax_and_oracle(rng, crop, masking):
    n, cap = 24, crop + 7
    bases, lengths = _bases(rng, n, cap, crop)
    want = np.asarray(jenc.encode_frames(
        jnp.asarray(bases), jnp.asarray(lengths), crop_size=crop,
        masking=masking))
    got = tenc.encode_frames(torch.from_numpy(bases),
                             torch.from_numpy(lengths), crop_size=crop,
                             masking=masking)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the literal string oracle over each window's valid prefix
    for i in range(n):
        m = min(int(lengths[i]), crop)
        seq = "".join(_CHARS[bases[i, :m]])
        ref = jenc.encode_frames_oracle(seq, crop, masking=masking)
        p = ref.shape[1]
        np.testing.assert_array_equal(got.numpy()[i, :, :p], ref)
        assert not got.numpy()[i, :, p:].any()


@pytest.mark.parametrize("width", [400, 499, 30])
@pytest.mark.parametrize("masking", [False, True])
def test_encode_frames_narrower_than_crop_matches_jax(rng, width, masking):
    """Windows narrower than the crop (``predict --fsize`` below the
    model's crop): the port used to raise in its reverse-complement
    gather; tokens must equal JAX's."""
    crop, n = 500, 24
    bases, _ = _bases(rng, n, width + 20, width)
    bases = bases[:, :width]
    lengths = np.concatenate([[width, width - 1, 3, 0],
                              rng.integers(0, width + 1, size=n - 4)]
                             ).astype(np.int32)
    want = np.asarray(jenc.encode_frames(
        jnp.asarray(bases), jnp.asarray(lengths), crop_size=crop,
        masking=masking))
    got = tenc.encode_frames(torch.from_numpy(bases),
                             torch.from_numpy(lengths), crop_size=crop,
                             masking=masking)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alphabet", ["AA", "MURPHY10", "PC5"])
def test_encode_reduced_alphabets_match_jax(rng, alphabet):
    bases, lengths = _bases(rng, 12, 130, 125)
    want = jenc.encode_frames(jnp.asarray(bases), jnp.asarray(lengths),
                              crop_size=125, alphabet=alphabet)
    got = tenc.encode_frames(torch.from_numpy(bases),
                             torch.from_numpy(lengths), crop_size=125,
                             alphabet=alphabet)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [500, 501, 1])
def test_pack_unpack_roundtrip_matches_jax(rng, length):
    bases = rng.integers(0, 9, size=(5, length)).astype(np.uint8)
    packed = tenc.pack_bases(bases)
    np.testing.assert_array_equal(packed, jenc.pack_bases(bases))
    got = tenc.unpack_bases(torch.from_numpy(packed), length)
    want = jenc.unpack_bases(jnp.asarray(packed), length)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), bases)


def test_codon_table_and_frame_positions_match_jax():
    for alphabet in ("CODON", "AA", "PC2"):
        np.testing.assert_array_equal(tenc.codon_table(alphabet),
                                      jenc.codon_table(alphabet))
    for crop in (5, 6, 7, 500, 1505):
        assert tenc.frame_positions(crop) == jenc.frame_positions(crop)


@pytest.mark.parametrize("masking", [False, True])
def test_planners_match_jax(rng, masking):
    crop = 1505
    plans = mask_cut_plan(_inline_flagship()["model"][
        "representation_learner"])
    assert plans == jax_mask_cut_plan(_inline_flagship()["model"][
        "representation_learner"])
    bases, lengths = _bases(rng, 40, crop + 3, crop)
    lengths[6:20] = crop
    for fn in ("dense_window_rows", "dense_window_batch"):
        np.testing.assert_array_equal(
            getattr(tenc, fn)(bases, lengths, crop, masking),
            getattr(jenc, fn)(bases, lengths, crop, masking))
    np.testing.assert_array_equal(
        tenc.bounded_mask_levels(bases, lengths, crop, masking, plans),
        jenc.bounded_mask_levels(bases, lengths, crop, masking, plans))
