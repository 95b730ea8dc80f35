"""The port's fixed-rate codec against the JAX package, bit for bit.

The same numpy inputs go through the JAX fixed-rate kernels (interpret-mode
Pallas, as tests/test_kernels.py runs them), the JAX oracles in
``repro.kernels.ref``, and the port's plain versions (CPU tensors dispatch
to them).  Payload, emax and the decoded values must be identical
(``np.array_equal``, decoded values down to their bit patterns).
"""
import os
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.compression import (encode_fixed_accuracy_batch as jax_encode_fa,
                               encode_fixed_rate_batch as jax_encode_fr)
from repro.compression import get_codec as jax_get_codec
from repro.compression.api import decode_stacked_payloads as jax_decode_stacked
from repro.kernels import ops as jops, ref as jref
from repro.kernels import zfp_codec as jzfp

from repro_torch.compression import (FixedRateCodec, compressed_nbytes_batch,
                                     decode_stacked_payloads,
                                     encode_fixed_accuracy_batch,
                                     encode_fixed_rate_batch, get_codec)
from repro_torch.kernels import ops, ref, zfp_codec

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """This file's own generator, fresh for every test.  The session-wide
    one in conftest.py hands each test whatever state the files run before
    it in the same worker left behind, so inputs changed with the order."""
    return np.random.default_rng(0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _blocks(rng, n_blocks, kind="rough"):
    if kind == "smooth":
        t = np.linspace(0, 3, n_blocks * 16)
        x = np.sin(t) * np.exp(-0.1 * t)
    else:
        x = rng.standard_normal(n_blocks * 16) * 10.0 ** rng.integers(-3, 3)
    return x.reshape(n_blocks, 16).astype(np.float32)


def _f1_blocks(rng):
    """emax -119 .. -99, subnormal inputs, and zero blocks (F1)."""
    rows = [(rng.uniform(-1, 1, 16) * 2.0 ** (em - 1)).astype(np.float32)
            for em in range(-119, -98)]
    sub = np.zeros(16, np.float32)
    sub[0], sub[1], sub[2] = 2.0 ** -100, 2.0 ** -127, -3 * 2.0 ** -128
    mixed = (rng.standard_normal(16) * 2.0 ** -110).astype(np.float32)
    mixed[::3] = np.float32(2.0 ** -130)
    tiny = np.full(16, 1e-40, np.float32)            # below the 2^-120 flush
    return np.stack(rows + [sub, mixed, tiny, np.zeros(16, np.float32)])


def _port_encode(blocks, bits):
    p, e = ops.zfp_encode_blocks(torch.from_numpy(blocks), bits)
    return _np(p), _np(e)


def _port_decode(payload, emax, bits):
    return _np(ops.zfp_decode_blocks(torch.from_numpy(np.array(payload, np.int32)),
                                     torch.from_numpy(np.array(emax, np.int32)),
                                     bits))


def _assert_same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


def _assert_encode_parity(blocks, bits, kernel=True):
    jb = jnp.asarray(blocks)
    want = [np.asarray(a) for a in jref.zfp_encode_blocks_ref(jb, bits)]
    if kernel:
        for a, b in zip(jops.zfp_encode_blocks(jb, bits), want):
            assert np.array_equal(np.asarray(a), b)
    got = _port_encode(blocks, bits)
    for name, a, b in zip(("payload", "emax"), got, want):
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert got[0].shape == (len(blocks), (bits + 1) // 2)
    return got


# ---------------------------------------------------------------------------
# kernels 3-4: the sweeps of tests/test_kernels.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 5, 8, 15, 23, 30])
@pytest.mark.parametrize("n_blocks", [1, 7, 256, 300])
def test_encode_fr_matches_jax(rng, bits, n_blocks):
    _assert_encode_parity(_blocks(rng, n_blocks), bits)


@pytest.mark.parametrize("bits, n_blocks",
                         [(b, n) for b in (2, 8, 16, 30) for n in (3, 256, 511)]
                         + [(3, 511), (13, 256), (29, 3)])
def test_decode_fr_matches_jax(rng, bits, n_blocks):
    payload, emax = _port_encode(_blocks(rng, n_blocks, "smooth"), bits)
    jp, je = jnp.asarray(payload), jnp.asarray(emax)
    want = np.asarray(jref.zfp_decode_blocks_ref(jp, je, bits))
    _assert_same_bits(np.asarray(jops.zfp_decode_blocks(jp, je, bits)), want)
    _assert_same_bits(_port_decode(payload, emax, bits), want)


@pytest.mark.parametrize("words", range(1, 16))
def test_decode_fr_every_width_matches_tpu_kernel(rng, words):
    """Kernel 3 at every width W = 1..15: arbitrary words at 2W bits (every
    bit of every word in use) and encoded blocks at 2W - 1 bits (the low half
    of the last word zero), against the TPU kernel in interpret mode."""
    for bits, payload, emax in [
            (2 * words,
             rng.integers(-2 ** 31, 2 ** 31, (67, words), dtype=np.int64).astype(np.int32),
             rng.integers(-30, 30, 67).astype(np.int32)),
            (2 * words - 1, *_port_encode(_blocks(rng, 67), 2 * words - 1))]:
        want = np.asarray(jzfp.zfp_decode_blocks(jnp.asarray(payload), jnp.asarray(emax),
                                                 bits, interpret=True))
        _assert_same_bits(_port_decode(payload, emax, bits), want)


@pytest.mark.parametrize("bits", [1, 7, 12, 29, 30])
def test_fr_denormal_and_zero_blocks(rng, bits):
    blocks = _f1_blocks(rng)
    p, e = _assert_encode_parity(blocks, bits, kernel=bits == 12)
    assert not p[-2:].any() and not e[-2:].any()     # flushed and zero blocks
    want = np.asarray(jref.zfp_decode_blocks_ref(jnp.asarray(p), jnp.asarray(e),
                                                 bits))
    _assert_same_bits(_port_decode(p, e, bits), want)


def test_fr_odd_rate_leaves_last_half_word_empty(rng):
    p, _ = _assert_encode_parity(_blocks(rng, 64), 13, kernel=False)
    assert p.shape[1] == 7 and not (p[:, -1] >> 16).any()


def test_fr_wrong_width_is_refused():
    payload = torch.zeros(4, 3, dtype=torch.int32)
    emax = torch.zeros(4, dtype=torch.int32)
    for bits in (4, 7, 31):
        with pytest.raises(ValueError, match="words"):
            ops.zfp_decode_blocks(payload, emax, bits)
    for bits in (0, 31):
        with pytest.raises(ValueError, match="bits_per_value"):
            ops.zfp_encode_blocks(torch.zeros(4, 16), bits)
    assert ops.zfp_decode_blocks(payload, emax, 6).shape == (4, 16)


def test_fr_cuda_wrappers_reject_cpu_tensors_without_building():
    with pytest.raises(ValueError, match="must be on"):
        zfp_codec.zfp_encode_blocks(torch.zeros(4, 16), 12)
    with pytest.raises(ValueError, match="must be on"):
        zfp_codec.zfp_decode_blocks(torch.zeros(4, 6, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32), 12)
    with pytest.raises(ValueError, match="words"):
        zfp_codec.zfp_decode_blocks(torch.zeros(4, 16, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32), 32)
    assert not zfp_codec._libs
    assert set(zfp_codec.LAUNCHES) == {"zfp_decode_blocks_fa",
                                       "zfp_encode_blocks_fa",
                                       "zfp_decode_blocks", "zfp_encode_blocks"}
    assert set(zfp_codec.SOURCES) == {"zfp_fa_decode", "zfp_fa_encode",
                                      "zfp_fr_decode", "zfp_fr_encode"}


# ---------------------------------------------------------------------------
# batch API and codec seam
# ---------------------------------------------------------------------------

def _samples(rng, n=5, c=3, h=22, w=15):
    t = np.linspace(0, 1, h)[:, None] + np.linspace(0, 1, w)[None, :]
    return np.stack([(s * (np.sin(5 * t + i) + 0.1 * rng.standard_normal((c, h, w))))
                     .astype(np.float32)
                     for i, s in enumerate(np.logspace(-1, 1, n))])


@pytest.mark.parametrize("bits", [5, 12])
def test_fixed_rate_batch_and_codec_match_jax(rng, bits):
    xs = _samples(rng)                                  # ragged: edge padding
    want = jax_encode_fr(jnp.asarray(xs), bits)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        (want.payload, want.emax, want.nplanes),
        (lambda f: (f.payload, f.emax, f.nplanes))(
            jax_encode_fr(jnp.asarray(xs), bits, use_pallas=True))))
    cf = encode_fixed_rate_batch(torch.from_numpy(xs), bits)
    assert cf.shape == tuple(want.shape)
    assert cf.padded_shape == tuple(want.padded_shape)
    for a, b in ((cf.payload, want.payload), (cf.emax, want.emax),
                 (cf.nplanes, want.nplanes)):
        assert np.array_equal(a.numpy(), np.asarray(b))

    codec = get_codec("fixed_rate", bits_per_value=bits)
    assert isinstance(codec, FixedRateCodec) and codec.name == "fixed_rate"
    cf2 = codec.encode_batch(torch.from_numpy(xs), tolerances=[1.0] * len(xs))
    for backend in ("jnp", "pallas"):
        jc = jax_get_codec("fixed_rate", bits_per_value=bits, backend=backend)
        jcf = jc.encode_batch(jnp.asarray(xs))
        assert np.array_equal(cf2.payload.numpy(), np.asarray(jcf.payload))
        _assert_same_bits(codec.decode_batch(cf2).numpy(),
                          np.asarray(jc.decode_batch(jcf)))
        assert np.array_equal(codec.nbytes(cf2).numpy(),
                              np.asarray(jc.nbytes(jcf)))
    nb = cf.emax.shape[1]
    assert codec.nbytes(cf2).tolist() == [nb + 2 * bits * nb] * len(xs)
    assert np.array_equal(compressed_nbytes_batch(cf, mode="fixed_accuracy").numpy()
                          - compressed_nbytes_batch(cf, mode="fixed_rate").numpy(),
                          np.full(len(xs), nb))
    with pytest.raises(ValueError, match="unknown codec mode"):
        compressed_nbytes_batch(cf, mode="lossless")


def test_decode_stacked_payloads_without_nplanes_matches_jax(rng):
    """FA streams trimmed per sample and zero-padded to the batch's widest,
    decoded by the fixed-rate kernel at 2 * wmax planes (the host stores'
    path), and by the FA kernel with nplanes."""
    xs = _samples(rng, n=6)
    tols = np.logspace(-4, -1, 6).astype(np.float32)
    cf = encode_fixed_accuracy_batch(torch.from_numpy(xs), torch.from_numpy(tols))
    jcf = jax_encode_fa(jnp.asarray(xs), jnp.asarray(tols))
    npl = cf.nplanes.numpy()
    widths = [int(np.ceil(n.max() / 2)) or 1 for n in npl]
    assert len(set(widths)) > 1
    wmax = max(widths)
    payload = np.zeros(cf.payload.shape[:2] + (wmax,), np.int32)
    for j, w in enumerate(widths):
        payload[j, :, :w] = cf.payload.numpy()[j, :, :w]
    emax = cf.emax.numpy()
    want = np.asarray(jax_decode_stacked(payload, emax, jcf.padded_shape, jcf.shape))
    got = decode_stacked_payloads(torch.from_numpy(payload), torch.from_numpy(emax),
                                  cf.padded_shape, cf.shape)
    _assert_same_bits(got.numpy(), want)
    with_npl = decode_stacked_payloads(torch.from_numpy(payload),
                                       torch.from_numpy(emax), cf.padded_shape,
                                       cf.shape, cf.nplanes)
    _assert_same_bits(with_npl.numpy(), want)
    assert float(np.abs(want - xs).max(axis=(1, 2, 3)).max() / tols.max()) <= 1


@pytest.mark.parametrize("shape", [(13, 22), (2, 9, 6)])
@pytest.mark.parametrize("bits", [12, 13, 20])
def test_encode_decode_field_match_jax(rng, shape, bits):
    """``ops.encode_field``/``decode_field`` (kernels 4 and 3 on one field)
    against the JAX package's on shapes that are no multiple of 4: the
    padded shape, payload, emax and the ``nplanes`` fill bit for bit, and
    the decode at ``2 * W`` planes (14 at 13 bits) cropped back."""
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-2, 2)).astype(np.float32)
    cf = ops.encode_field(torch.from_numpy(x), bits)
    jcf = jops.encode_field(jnp.asarray(x), bits)
    assert (cf.shape, cf.padded_shape) == (tuple(jcf.shape), tuple(jcf.padded_shape))
    for f in ("payload", "emax", "nplanes"):
        a, b = _np(getattr(cf, f)), np.asarray(getattr(jcf, f))
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert np.all(_np(cf.nplanes) == bits)
    got = ops.decode_field(cf)
    assert got.shape == shape
    _assert_same_bits(got.numpy(), np.asarray(jops.decode_field(jcf)))


def test_codec_registry():
    assert get_codec("fixed_rate").bits_per_value == 12
    assert get_codec("fixed_accuracy+residual").name == "fixed_accuracy+residual"
    with pytest.raises(ValueError, match="bits_per_value"):
        encode_fixed_rate_batch(torch.zeros(1, 4, 4), 31)


def test_plain_versions_are_the_ones_ops_runs_on_the_cpu(rng):
    blocks = torch.from_numpy(_blocks(rng, 33))
    p, e = ref.zfp_encode_blocks_ref(blocks, 9)
    q, f = ops.zfp_encode_blocks(blocks, 9)
    assert torch.equal(p, q) and torch.equal(e, f)
    assert torch.equal(ref.zfp_decode_blocks_ref(p, e, 9),
                       ops.zfp_decode_blocks(p, e, 9))


def test_launch_counts_survive_concurrent_launches():
    """The prefetch worker and the main thread both count launches; the
    lock keeps every count (more threads than cores, a tiny switch
    interval)."""
    per_thread, n_threads = 2000, 4 * (os.cpu_count() or 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        zfp_codec.reset_launches()
        threads = [threading.Thread(target=lambda: [
            zfp_codec._counted("zfp_decode_blocks") for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert zfp_codec.LAUNCHES["zfp_decode_blocks"] == per_thread * n_threads
    finally:
        sys.setswitchinterval(old)
        zfp_codec.reset_launches()
