"""The codec's single-sample functions, the ``Codec`` protocol and
``count_params`` against the JAX package's.

``encode_fixed_rate`` / ``decode_fixed_rate`` / ``encode_fixed_accuracy`` /
``decode`` / ``compressed_nbytes`` / ``compression_ratio`` take one
unbatched field, as in ``repro/compression/zfp.py``; the port writes them
with its batch forms on a batch of one.  Payload, emax, plane counts,
decoded values, bytes and ratio are held to the JAX functions' bit for
bit, as ``test_torch_codec.py`` and ``test_torch_fixed_rate.py`` hold the
batch forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compression as jzfp
from repro.models import nn as jnn
from repro.models.surrogate import SurrogateConfig as JaxSurrogateConfig
from repro.models.surrogate import init_surrogate as jax_init_surrogate

import repro_torch.compression as zfp
from repro_torch.compression import Codec, codec_names, get_codec
from repro_torch.models.nn import count_params
from repro_torch.models.surrogate import SurrogateConfig, init_surrogate

torch.set_num_threads(2)

SHAPES = [(22, 15), (4, 4), (3, 16, 9)]


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))).astype(np.float32)


def _assert_field_equal(cf, jcf):
    assert cf.shape == tuple(jcf.shape) and cf.padded_shape == tuple(jcf.padded_shape)
    for name in ("payload", "emax", "nplanes"):
        got, want = getattr(cf, name), np.asarray(getattr(jcf, name))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bits", [1, 8, 12, 13, 30])
def test_fixed_rate_single_matches_jax(shape, bits):
    x = _x(shape, bits)
    jcf = jzfp.encode_fixed_rate(jnp.asarray(x), bits)
    cf = zfp.encode_fixed_rate(torch.from_numpy(x), bits)
    _assert_field_equal(cf, jcf)
    for got, want in ((zfp.decode_fixed_rate(cf), jzfp.decode_fixed_rate(jcf)),
                      (zfp.decode(cf), jzfp.decode(jcf))):
        assert got.shape == shape and np.array_equal(got.numpy(), np.asarray(want))
    assert int(zfp.compressed_nbytes(cf, "fixed_rate")) == \
        int(jzfp.compressed_nbytes(jcf, "fixed_rate"))
    assert np.float32(zfp.compression_ratio(cf, "fixed_rate")) == \
        np.asarray(jzfp.compression_ratio(jcf, "fixed_rate"))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("tol", [1e-5, 1e-3, 0.1, 3.0])
def test_fixed_accuracy_single_matches_jax(shape, tol):
    x = _x(shape, 7)
    jcf = jzfp.encode_fixed_accuracy(jnp.asarray(x), tol)
    cf = zfp.encode_fixed_accuracy(torch.from_numpy(x), tol)
    _assert_field_equal(cf, jcf)
    got = zfp.decode(cf)
    assert np.array_equal(got.numpy(), np.asarray(jzfp.decode(jcf)))
    assert float((got - torch.from_numpy(x)).abs().max()) <= tol
    for mode in ("fixed_accuracy", "fixed_rate"):
        assert int(zfp.compressed_nbytes(cf, mode)) == int(jzfp.compressed_nbytes(jcf, mode))
        assert np.float32(zfp.compression_ratio(cf, mode)) == \
            np.asarray(jzfp.compression_ratio(jcf, mode))


def test_single_forms_are_the_batch_forms_on_one_sample():
    x = _x((3, 12, 8), 3)
    cf = zfp.encode_fixed_accuracy(torch.from_numpy(x), 1e-2)
    batch = zfp.encode_fixed_accuracy_batch(torch.from_numpy(x)[None],
                                            torch.tensor([1e-2]))
    for name in ("payload", "emax", "nplanes"):
        assert torch.equal(getattr(cf, name), getattr(batch, name)[0])
    assert torch.equal(zfp.decode(cf), zfp.decode_batch(batch)[0])
    assert int(zfp.compressed_nbytes(cf)) == int(zfp.compressed_nbytes_batch(batch)[0])


def test_single_forms_are_exported_where_jax_exports_them():
    for name in ("encode_fixed_rate", "decode_fixed_rate", "encode_fixed_accuracy",
                 "decode", "compressed_nbytes", "compression_ratio", "Codec"):
        assert name in zfp.__all__ and name in jzfp.__all__, name


@pytest.mark.parametrize("name", ["fixed_accuracy", "fixed_rate", "fixed_accuracy+residual"])
def test_every_registered_codec_is_a_codec(name):
    assert name in codec_names()
    kw = {"bits_per_value": 12} if name == "fixed_rate" else {"tolerance": 1e-3}
    assert isinstance(get_codec(name, **kw), Codec)
    assert not isinstance(object(), Codec)


def test_count_params_matches_jax():
    jparams = jax_init_surrogate(jax.random.PRNGKey(0), JaxSurrogateConfig(
        height=16, width=16, base_channels=8))
    model = init_surrogate(SurrogateConfig(height=16, width=16, base_channels=8),
                           device="cpu")
    n = jnn.count_params(jparams)
    assert count_params(model) == count_params(model.state_dict()) == n
    assert count_params(jax.tree.map(np.asarray, jparams)) == n
    assert count_params({"a": [torch.zeros(2, 3), None], "b": (np.zeros(4),)}) == 10
