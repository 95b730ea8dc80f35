"""NaN and +-inf through the port's codec against the JAX package.

The same numpy blocks (a standard-normal draw with a NaN, +inf and -inf
each in one block, an all-NaN block, a NaN beside values whose fixed-point
image passes 2^31, a NaN beside an inf, and finite controls) go through the
port's plain encoders, the JAX jnp encoders (``repro.kernels.ref``) and the
Pallas kernels in interpret mode, fixed-accuracy at tol 1e-3 and 1e-7 and
fixed-rate at 12 and 30 bits.

* A block holding NaN: payload, emax and nplanes equal both JAX references
  (the maximum propagates NaN, so emax is 0; the conversion to int32
  saturates as XLA's does: NaN to 0, out of range to INT_MAX / INT_MIN).
* A block holding +-inf and no NaN: they equal the Pallas kernels, which
  read emax from the exponent field (129); the jnp encoders take it through
  ``jnp.frexp`` (0), so the reference disagrees with itself there, and the
  port follows the kernels its CUDA kernels replace.
* Finite blocks are unchanged: equal to both.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import zfp_codec as jzfp

from repro_torch.compression import transform as T
from repro_torch.kernels import ops

torch.set_num_threads(2)

NAN_ROWS = (0, 3, 5, 6)       # blocks holding a NaN
INF_ROWS = (1, 2)             # blocks holding +-inf and no NaN
FINITE_ROWS = (4, 7)


def _blocks() -> np.ndarray:
    x = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    x[0, 5] = np.nan
    x[1, 9] = np.inf
    x[2, 0] = -np.inf
    x[3] = np.nan
    x[5, 2] = np.nan                   # emax 0: 9 2^28 and -12 2^28 leave int32
    x[5, 7], x[5, 11] = 9.0, -12.0
    x[6, 1], x[6, 4] = np.nan, np.inf  # NaN wins the maximum
    x[7] *= 1e3
    return x


def _np(arrays):
    return [np.asarray(a) for a in arrays]


def _encode_fa(x, tol):
    tols = np.full(x.shape[0], tol, np.float32)
    port = _np(a.numpy() for a in ops.zfp_encode_blocks_fa(torch.from_numpy(x),
                                                           torch.from_numpy(tols)))
    jnp_ref = _np(jref.zfp_encode_blocks_fa_ref(jnp.asarray(x), jnp.asarray(tols)))
    pallas = _np(jzfp.zfp_encode_blocks_fa(jnp.asarray(x), jnp.asarray(tols),
                                           interpret=True))
    return port, jnp_ref, pallas


def _encode_fr(x, bits):
    port = _np(a.numpy() for a in ops.zfp_encode_blocks(torch.from_numpy(x), bits))
    jnp_ref = _np(jref.zfp_encode_blocks_ref(jnp.asarray(x), bits))
    pallas = _np(jzfp.zfp_encode_blocks(jnp.asarray(x), bits, interpret=True))
    return port, jnp_ref, pallas


def _rows_equal(a, b, rows):
    return all(np.array_equal(p[list(rows)], q[list(rows)]) for p, q in zip(a, b))


def _check(port, jnp_ref, pallas):
    names = ("payload", "emax", "nplanes")[:len(port)]
    for name, p, j, k in zip(names, port, jnp_ref, pallas):
        for rows in (NAN_ROWS, FINITE_ROWS):
            assert np.array_equal(p[list(rows)], j[list(rows)]), (name, rows)
            assert np.array_equal(p[list(rows)], k[list(rows)]), (name, rows)
        assert np.array_equal(p[list(INF_ROWS)], k[list(INF_ROWS)]), name
    # the reference's own disagreement on +-inf: jnp.frexp(inf) gives 0
    assert port[1][list(INF_ROWS)].tolist() == [129, 129]
    assert jnp_ref[1][list(INF_ROWS)].tolist() == [0, 0]
    assert pallas[1][list(INF_ROWS)].tolist() == [129, 129]
    assert not _rows_equal(port, jnp_ref, INF_ROWS)
    assert port[1][list(NAN_ROWS)].tolist() == [0] * len(NAN_ROWS)


@pytest.mark.parametrize("tol", [1e-3, 1e-7])
def test_fixed_accuracy_nonfinite_blocks_follow_the_kernels(tol):
    x = _blocks()
    port, jnp_ref, pallas = _encode_fa(x, tol)
    _check(port, jnp_ref, pallas)
    # a NaN error is never above tol: a NaN block stops at the guess (the
    # all-NaN block quantizes to zeros and codes as a zero block)
    guess = min(0 - int(np.floor(np.log2(np.float32(tol)))) + 2, 30)
    assert port[2][[0, 5, 6]].tolist() == [guess] * 3 and port[2][3] == 0
    # and the streams decode as the Pallas decode decodes them
    got = ops.zfp_decode_blocks_fa(*map(torch.from_numpy, port)).numpy()
    want = np.asarray(jzfp.zfp_decode_blocks_fa(*map(jnp.asarray, pallas),
                                                interpret=True))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bits", [12, 30])
def test_fixed_rate_nonfinite_blocks_follow_the_kernels(bits):
    x = _blocks()
    port, jnp_ref, pallas = _encode_fr(x, bits)
    _check(port, jnp_ref, pallas)
    got = ops.zfp_decode_blocks(*map(torch.from_numpy, port), bits).numpy()
    want = np.asarray(jzfp.zfp_decode_blocks(*map(jnp.asarray, pallas), bits,
                                             interpret=True))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_quantize_saturates_as_xla_converts():
    """NaN to 0, at or past +-2^31 to INT_MAX / INT_MIN, as
    ``jnp.round(x).astype(jnp.int32)`` gives (torch's own cast gives
    INT_MIN for all of them on the CPU)."""
    vals = np.array([np.nan, np.inf, -np.inf, 2.0 ** 31, -2.0 ** 31, 3e9, -3e9,
                     2147483520.0, -2.5, 2.5, 0.0], np.float32)
    want = np.asarray(jnp.round(jnp.asarray(vals)).astype(jnp.int32))
    got = T.to_int32_saturating(torch.round(torch.from_numpy(vals))).numpy()
    assert np.array_equal(got, want)
    # through the quantizer: a NaN block (emax 0) with values past 8
    blocks = torch.from_numpy(_blocks()[5:6])
    q = T.quantize_blocks(blocks, T.block_emax(blocks)).numpy()[0]
    assert (q[2], q[7], q[11]) == (0, 2 ** 31 - 1, -2 ** 31)


def test_block_emax_reads_the_exponent_field():
    x = _blocks()
    got = T.block_emax(torch.from_numpy(x)).numpy()
    mx = np.abs(x).max(axis=1)
    finite = np.isfinite(mx)
    assert np.array_equal(got[finite], np.frexp(mx[finite])[1])
    assert got[list(INF_ROWS)].tolist() == [129, 129]
    assert got[list(NAN_ROWS)].tolist() == [0] * len(NAN_ROWS)
    # finite edges unchanged: the 2^-120 flush and exact powers of two
    edge = np.zeros((4, 16), np.float32)
    edge[0, 0], edge[1, 0], edge[2, 0], edge[3, 0] = 2.0 ** -121, 2.0 ** -120, 1.0, 0.5
    assert T.block_emax(torch.from_numpy(edge)).tolist() == [0, -119, 1, 0]
