"""The gathered fixed-accuracy decode against the JAX package.

``ops.zfp_decode_blocks_fa_gather`` decodes the samples ``idx`` of a
device-resident store straight into the field layout (on the card: one
kernel launch).  Its plain version must be bit-identical to the JAX
package's ``_gather_decode`` (jitted gather + decode, its CPU path) on the
same numpy arrays: mixed per-block plane counts from 0 to 30, a ragged
field that is cropped, unordered and repeated indices, a batch of one.
``DeviceResidentCompressedStore.decode_indices`` goes through it.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.data.device_store import _gather_decode

from repro_torch.compression import (decode_stacked_payloads,
                                     encode_fixed_accuracy_batch, trim_to_nplanes)
from repro_torch.data import DeviceResidentCompressedStore
from repro_torch.kernels import ops, ref, zfp_codec

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _store(rng, n, shape, tol=1e-3, deep=False):
    """Resident arrays of ``n`` samples of ``shape`` encoded by the port at
    ``tol`` (or at full depth, every word in use) and trimmed to the
    widest block, with the cropped and padded shapes."""
    xs = (rng.standard_normal((n,) + shape)
          * 10.0 ** rng.integers(-2, 2, (n,) + (1,) * len(shape))).astype(np.float32)
    tols = torch.full((n,), 2.0 ** -126 if deep else tol)
    cf = trim_to_nplanes(encode_fixed_accuracy_batch(torch.from_numpy(xs), tols))
    return cf.payload, cf.emax, cf.nplanes, cf.padded_shape, cf.shape


def _jax(payload, emax, nplanes, idx, padded_shape, shape):
    return np.asarray(_gather_decode(jnp.asarray(payload.numpy()),
                                     jnp.asarray(emax.numpy()),
                                     jnp.asarray(nplanes.numpy()),
                                     jnp.asarray(np.asarray(idx)),
                                     tuple(padded_shape), tuple(shape)))


def _port(payload, emax, nplanes, idx, padded_shape, shape):
    return ops.zfp_decode_blocks_fa_gather(payload, emax, nplanes,
                                           torch.as_tensor(np.asarray(idx)),
                                           padded_shape, shape).numpy()


CASES = {
    "main-like, shuffled and repeated": ((6, 24, 8), 9, [7, 2, 2, 0, 8, 5, 7, 1]),
    "ragged (3, 10, 7) cropped": ((3, 10, 7), 5, [4, 0, 3, 3, 1]),
    "batch of one": ((2, 12, 16), 4, [3]),
    "one block a sample (1, 3, 2)": ((1, 3, 2), 6, [5, 0, 5, 2, 1, 4, 3]),
    "no lead dim (10, 13)": ((10, 13), 3, [2, 1, 0, 2]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gathered_decode_matches_jax(rng, case):
    shape, n, idx = CASES[case]
    arrays = _store(rng, n, shape)
    want = _jax(*arrays[:3], idx, *arrays[3:])
    got = _port(*arrays[:3], idx, *arrays[3:])
    assert got.shape == (len(idx),) + shape
    assert _same_bits(got, want)


def test_gathered_decode_masks_each_block_as_jax(rng):
    """Full-depth streams (15 words) under per-block plane counts 0..30:
    each block's dropped planes are masked off, exactly as in JAX."""
    payload, emax, _, padded, shape = _store(rng, 5, (3, 10, 7), deep=True)
    assert payload.shape[-1] == 15
    npl = torch.from_numpy(rng.integers(0, 31, emax.shape).astype(np.int32))
    npl.view(-1)[:31] = torch.arange(31, dtype=torch.int32)
    idx = [4, 1, 1, 0, 3, 2]
    want = _jax(payload, emax, npl, idx, padded, shape)
    assert _same_bits(_port(payload, emax, npl, idx, padded, shape), want)
    # and the mask is what made them differ from the full-depth decode
    full = torch.full_like(npl, 30)
    assert not _same_bits(_port(payload, emax, full, idx, padded, shape), want)


def test_gathered_plain_version_is_the_flat_composition(rng):
    payload, emax, npl, padded, shape = _store(rng, 7, (3, 10, 7))
    idx = torch.tensor([6, 0, 6, 3])
    want = decode_stacked_payloads(payload[idx], emax[idx], padded, shape, npl[idx])
    got = ref.zfp_decode_blocks_fa_gather_ref(payload, emax, npl, idx, padded, shape)
    assert got.is_contiguous() and _same_bits(got.numpy(), want.numpy())


def test_decode_indices_goes_through_ops(rng, monkeypatch):
    payload, emax, npl, padded, shape = _store(rng, 6, (2, 10, 7))
    store = DeviceResidentCompressedStore(payload, emax, npl, shape, padded,
                                          np.full(6, 1e-3, np.float32),
                                          np.full(6, 100, np.int64))
    calls = []
    real = ops.zfp_decode_blocks_fa_gather

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(ops, "zfp_decode_blocks_fa_gather", spy)
    idx = torch.tensor([5, 1, 1, 0], dtype=torch.int32)      # cast to int64
    got = store.decode_indices(idx)
    assert len(calls) == 1 and calls[0].dtype == torch.int64
    want = decode_stacked_payloads(payload[idx.long()], emax[idx.long()], padded,
                                   shape, npl[idx.long()])
    assert _same_bits(got.numpy(), want.numpy())
    assert _same_bits(store.get_batch(np.array([5, 1, 1, 0])).numpy(), got.numpy())


@pytest.mark.parametrize("bad", [[0, 6], [-1], [2, 100]])
def test_index_out_of_range_raises(rng, bad):
    payload, emax, npl, padded, shape = _store(rng, 6, (1, 4, 4))
    with pytest.raises(IndexError, match="out of range"):
        ops.zfp_decode_blocks_fa_gather(payload, emax, npl, torch.tensor(bad),
                                        padded, shape)


def test_gathered_shapes_are_checked(rng):
    payload, emax, npl, padded, shape = _store(rng, 3, (2, 10, 7))
    assert zfp_codec.check_field(payload.shape[1], padded, shape) == (2, 10, 7, 12, 8)
    assert zfp_codec.check_field(12, (12, 16), (9, 13)) == (1, 9, 13, 12, 16)
    idx = torch.tensor([0])
    for bad_padded, bad_shape in (((2, 12, 8), (3, 10, 7)),    # lead dims differ
                                  ((2, 12, 8), (2, 13, 7)),    # crop past the pad
                                  ((2, 10, 8), (2, 10, 7)),    # pad not 4-aligned
                                  ((2, 16, 8), (2, 10, 7))):   # blocks do not tile
        with pytest.raises(ValueError):
            ops.zfp_decode_blocks_fa_gather(payload, emax, npl, idx, bad_padded,
                                            bad_shape)


def test_gathered_cuda_wrapper_rejects_cpu_tensors_without_building(rng):
    payload, emax, npl, padded, shape = _store(rng, 3, (2, 10, 7))
    with pytest.raises(ValueError, match="must be on"):
        zfp_codec.zfp_decode_blocks_fa_gather(payload, emax, npl, torch.tensor([0]),
                                              padded, shape)
    with pytest.raises(ValueError, match="payload must be"):
        zfp_codec.zfp_decode_blocks_fa_gather(payload[0], emax, npl, torch.tensor([0]),
                                              padded, shape)
    assert not zfp_codec._libs


def _fake_lib(*names):
    return types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})


def test_bind_takes_libraries_with_and_without_the_gathered_entry():
    """An older checkout's library (a --baseline build) has only the flat
    decode; binding it must not fail, and it reports no gathered entry."""
    others = {"zfp_fa_encode": _fake_lib("zfp_encode_blocks_fa_launch"),
              "zfp_fr_decode": _fake_lib("zfp_decode_blocks_launch"),
              "zfp_fr_encode": _fake_lib("zfp_encode_blocks_launch")}
    old = zfp_codec.bind({"zfp_fa_decode": _fake_lib("zfp_decode_blocks_fa_launch"),
                          **others})
    assert not zfp_codec.has_gather(old)
    assert len(old["zfp_fa_decode"].zfp_decode_blocks_fa_launch.argtypes) == 7
    new = zfp_codec.bind({"zfp_fa_decode": _fake_lib("zfp_decode_blocks_fa_launch",
                                                     zfp_codec.GATHER_ENTRY),
                          **others})
    assert zfp_codec.has_gather(new)
    # 5 pointers, N and B, nb, W, lead, H, W, padded H and W, the stream
    assert len(getattr(new["zfp_fa_decode"], zfp_codec.GATHER_ENTRY).argtypes) == 15
