"""The port's fixed-accuracy codec against the JAX package, bit for bit.

The same numpy inputs go through the JAX kernels (interpret-mode Pallas, as
tests/test_kernels.py runs them), the JAX oracles in ``repro.kernels.ref``
(jitted, through ``repro.kernels.ops.*_fast``), and the port's plain versions (CPU tensors dispatch to them).  Payload,
emax, nplanes and the decoded values must be identical (``np.array_equal``)
everywhere except at the documented F2 divergence: tolerances that are
exact powers of two >= 2^13, where XLA's ``log2`` lands below the integer.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.compression import (decode, decode_batch as jax_decode_batch,
                               encode_fixed_accuracy,
                               encode_fixed_accuracy_batch as jax_encode_batch,
                               compressed_nbytes_batch as jax_nbytes,
                               trim_to_nplanes as jax_trim)
from repro.compression import transform as JT
from repro.data import DeviceResidentCompressedStore as JaxStore
from repro.kernels import ops as jops, ref as jref
from repro.kernels import zfp_codec as jzfp

from repro_torch.compression import (compressed_nbytes_batch, decode_batch,
                                     encode_fixed_accuracy_batch, floor_log2,
                                     get_codec, trim_to_nplanes)
from repro_torch.compression import transform as T
from repro_torch.data import DeviceResidentCompressedStore
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


def _port_encode(blocks, tols):
    return [_np(a) for a in ops.zfp_encode_blocks_fa(torch.from_numpy(blocks),
                                                     torch.from_numpy(tols))]


def _port_decode(payload, emax, nplanes):
    return _np(ops.zfp_decode_blocks_fa(
        torch.from_numpy(np.array(payload, np.int32)),
        torch.from_numpy(np.array(emax, np.int32)),
        torch.from_numpy(np.array(nplanes, np.int32))))


def _assert_encode_parity(blocks, tols, kernel=True):
    """Port plain encode == JAX oracle (== JAX kernel), then the decodes."""
    jb, jt = jnp.asarray(blocks), jnp.asarray(tols)
    want = [np.asarray(a) for a in jops.zfp_encode_blocks_fa_fast(jb, jt)]
    if kernel:
        got_k = [np.asarray(a) for a in jops.zfp_encode_blocks_fa(jb, jt)]
        for a, b in zip(got_k, want):
            assert np.array_equal(a, b)
    got = _port_encode(blocks, tols)
    for name, a, b in zip(("payload", "emax", "nplanes"), got, want):
        assert np.array_equal(a, b), name
    dec_want = np.asarray(jops.zfp_decode_blocks_fa_fast(*map(jnp.asarray, want)))
    dec_got = _port_decode(*got)
    assert np.array_equal(dec_got, dec_want)
    # bit patterns too (sign of flushed zeros included)
    assert np.array_equal(dec_got.view(np.int32), dec_want.view(np.int32))
    return got, dec_got


# ---------------------------------------------------------------------------
# encode: the sweeps of tests/test_kernels.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol", [1e-4, 1e-2, 0.5])
@pytest.mark.parametrize("n_blocks", [1, 7, 256, 300])
def test_encode_fa_matches_jax(rng, n_blocks, tol):
    blocks = _blocks(rng, n_blocks)
    _assert_encode_parity(blocks, np.full(n_blocks, tol, np.float32))


def test_encode_fa_mixed_tolerances(rng):
    blocks = _blocks(rng, 192)
    tols = (10.0 ** rng.uniform(-5, 0, 192)).astype(np.float32)
    _assert_encode_parity(blocks, tols, kernel=False)


def test_encode_fa_zero_blocks():
    blocks = np.zeros((40, 16), np.float32)
    blocks[7] = 1e-40                         # below the 2^-120 flush
    (p, e, n), dec = _assert_encode_parity(blocks,
                                           np.full(40, 1e-3, np.float32),
                                           kernel=False)
    assert not p.any() and not e.any() and not n.any() and not dec.any()


@pytest.mark.parametrize("tol", [1e-3, 1e-1])
def test_encode_fa_roundtrip_honors_bound(rng, tol):
    blocks = _blocks(rng, 128, "smooth")
    _, dec = _assert_encode_parity(blocks, np.full(128, tol, np.float32),
                                   kernel=False)
    assert float(np.max(np.abs(dec - blocks))) <= tol


# ---------------------------------------------------------------------------
# decode: variable plane counts
# ---------------------------------------------------------------------------

def _fa_field(n_blocks, tol):
    side = int(np.ceil(np.sqrt(n_blocks)))
    x = (np.sin(np.linspace(0, 5, side * side * 16))
         * np.logspace(-2, 1, side * side * 16)).astype(np.float32)
    return encode_fixed_accuracy(jnp.asarray(x.reshape(side * 4, side * 4)), tol)


@pytest.mark.parametrize("tol", [1e-4, 1e-2, 0.5])
@pytest.mark.parametrize("n_blocks", [1, 7, 256, 300])
def test_decode_fa_matches_jax(n_blocks, tol):
    cf = _fa_field(n_blocks, tol)
    want = np.asarray(jops.zfp_decode_blocks_fa(cf.payload, cf.emax, cf.nplanes))
    assert np.array_equal(want, np.asarray(jops.zfp_decode_blocks_fa_fast(
        cf.payload, cf.emax, cf.nplanes)))
    got = _port_decode(cf.payload, cf.emax, cf.nplanes)
    assert np.array_equal(got, want)
    expect = np.asarray(JT.blockify(JT.pad_to_blocks(decode(cf))))
    assert np.array_equal(got, expect)


def test_decode_fa_zero_plane_blocks(rng):
    x = rng.standard_normal((16, 16)).astype(np.float32)
    x[:4, :] = 0.0
    cf = encode_fixed_accuracy(jnp.asarray(x), 1e-3)
    assert int(cf.nplanes.min()) == 0 and int(cf.nplanes.max()) > 0
    got = _port_decode(cf.payload, cf.emax, cf.nplanes)
    assert np.all(got[np.asarray(cf.nplanes) == 0] == 0.0)
    assert np.array_equal(got, np.asarray(jops.zfp_decode_blocks_fa(
        cf.payload, cf.emax, cf.nplanes)))


def test_decode_fa_full_plane_blocks(rng):
    x = (10.0 * rng.standard_normal((8, 8))).astype(np.float32)
    cf = encode_fixed_accuracy(jnp.asarray(x), 1e-12)
    assert int(cf.nplanes.max()) == T.TOTAL_PLANES
    got = _port_decode(cf.payload, cf.emax, cf.nplanes)
    assert np.array_equal(got, np.asarray(JT.blockify(JT.pad_to_blocks(decode(cf)))))


def test_decode_fa_masks_planes_below_count(rng):
    """Full-depth words with per-block counts 0..30: the mask must zero the
    planes beyond each block's count."""
    blocks = jnp.asarray(_blocks(rng, 64))
    payload, emax = jref.zfp_encode_blocks_ref(blocks, 30)
    nplanes = jnp.asarray((np.arange(64) % 31).astype(np.int32))
    want = np.asarray(jops.zfp_decode_blocks_fa(payload, emax, nplanes))
    got = _port_decode(payload, emax, nplanes)
    assert np.array_equal(got, want)
    unmasked = np.asarray(jref.zfp_decode_blocks_ref(payload, emax, 30))
    assert not np.array_equal(got, unmasked)


# ---------------------------------------------------------------------------
# F1: subnormals and blocks whose scale leaves the normal range
# ---------------------------------------------------------------------------

def _f1_blocks(rng):
    rows = [(rng.uniform(-1, 1, 16) * 2.0 ** (em - 1)).astype(np.float32)
            for em in range(-119, -98)]              # emax -119 .. -99
    sub = np.zeros(16, np.float32)
    sub[0], sub[1], sub[2] = 2.0 ** -100, 2.0 ** -127, -3 * 2.0 ** -128
    mixed = (rng.standard_normal(16) * 2.0 ** -110).astype(np.float32)
    mixed[::3] = np.float32(2.0 ** -130)            # subnormal inputs
    return np.stack(rows + [sub, mixed]).astype(np.float32)


@pytest.mark.parametrize("tol", [2.0 ** -126, 1e-36, 1e-32, 1e-3])
def test_encode_fa_denormal_blocks(rng, tol):
    blocks = _f1_blocks(rng)
    _assert_encode_parity(blocks, np.full(len(blocks), tol, np.float32),
                          kernel=False)


def test_decode_fa_denormal_blocks(rng):
    """Full-depth streams of the F1 blocks: coefficients whose value falls
    below 2^-126 decode to (flushed) zero, as in XLA."""
    blocks = jnp.asarray(_f1_blocks(rng))
    payload, emax = jref.zfp_encode_blocks_ref(blocks, 30)
    nplanes = jnp.full((blocks.shape[0],), 30, jnp.int32)
    want = np.asarray(jops.zfp_decode_blocks_fa_fast(payload, emax, nplanes))
    got = _port_decode(payload, emax, nplanes)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_flush_matters_for_denormal_blocks():
    """Without the explicit flush, PyTorch on the CPU keeps subnormals: in
    a block with emax -99 they quantize to (1, -2) instead of (0, 0)."""
    x = torch.zeros(1, 16)
    x[0, 0], x[0, 1], x[0, 2] = 2.0 ** -100, 2.0 ** -127, -3 * 2.0 ** -128
    emax = T.block_emax(x)
    assert int(emax[0]) == -99
    raw = torch.round(x * 2.0 ** 64 * 2.0 ** 63).to(torch.int32)
    assert raw[0, 1:3].tolist() == [1, -2]
    assert T.quantize_blocks(x, emax)[0, 1:3].tolist() == [0, 0]
    deq = T.dequantize_blocks(torch.ones(1, 16, dtype=torch.int32),
                              torch.tensor([-100], dtype=torch.int32))
    assert float(deq.abs().max()) == 0.0


def _f3_blocks(rng):
    """Blocks whose error check depends on the fused multiply-add: values
    just above 2^-126 beside one that sets emax -100..-110 (a dequantized
    value below 2^-126 enters the difference unflushed), and values near the
    f32 maximum (a dequantized value above it does not overflow)."""
    rows = []
    for emax in range(-110, -99):
        b = np.sign(rng.standard_normal((8, 16))) * 2.0 ** -126 * (
            1 + 2.0 ** -rng.integers(2, 23, (8, 16)).astype(np.float64))
        b[:, 0] = 1.5 * 2.0 ** (emax - 1)
        rows.append(b)
    tiny = np.concatenate(rows).astype(np.float32)
    big = (rng.choice([-1.0, 1.0], (64, 16)) * np.finfo(np.float32).max
           * (1 - 2.0 ** -rng.integers(1, 24, (64, 16)).astype(np.float64))).astype(np.float32)
    return [(tiny, np.float32(2.0 ** -126)), (big, np.float32(1.5 * 2.0 ** 110))]


def test_encode_fa_error_is_one_fused_multiply_add(rng):
    """F3: XLA contracts the dequantize's last multiply and the error's
    subtraction into one FMA, so the reference neither flushes a
    dequantized value below 2^-126 nor overflows one above the f32 range
    before the difference.  The port matches the TPU kernel and the oracle;
    flushing and rounding the product first (as the port did before) does
    not."""
    for blocks, tol in _f3_blocks(rng):
        tols = np.full(len(blocks), tol, np.float32)
        want = [np.asarray(a) for a in jzfp.zfp_encode_blocks_fa(
            jnp.asarray(blocks), jnp.asarray(tols), interpret=True)]
        _assert_encode_parity(blocks, tols, kernel=False)
        got = _port_encode(blocks, tols)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        x, t = torch.from_numpy(blocks), torch.from_numpy(tols)
        emax = T.block_emax(T.flush_denormals(x))
        u = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(T.flush_denormals(x), emax)))
        npl = torch.clamp(emax - floor_log2(t) + 2, 0, T.TOTAL_PLANES)
        for _ in range(6):                  # the six passes with the product flushed first
            dec = T.dequantize_blocks(T.inv_transform_2d(T.nb2int(T.truncate_planes(u, npl))),
                                      emax)
            bad = T.flush_denormals(dec - T.flush_denormals(x)).abs().amax(-1) > t
            npl = torch.where(bad, torch.clamp(npl + 2, max=T.TOTAL_PLANES), npl)
        assert not np.array_equal(npl.numpy(), want[2])


# ---------------------------------------------------------------------------
# F2: floor(log2(tol)) at exact powers of two
# ---------------------------------------------------------------------------

def test_floor_log2_exact_at_powers_of_two():
    ks = np.arange(-126, 64)
    t = torch.from_numpy((2.0 ** ks).astype(np.float32))
    assert np.array_equal(floor_log2(t).numpy(), ks)
    v = (10.0 ** np.random.default_rng(1).uniform(-30, 18, 4096)).astype(np.float32)
    assert np.array_equal(floor_log2(torch.from_numpy(v)).numpy(),
                          np.floor(np.log2(v.astype(np.float64))).astype(np.int32))


@pytest.mark.parametrize("k", [13, 14, 15, 20, 26, 27, 30, 31, 40])
def test_encode_fa_power_of_two_tolerances(rng, k):
    """Where XLA's log2 is exact the port is bit-identical; where it lands
    below k (the documented F2 divergence) the JAX package guesses one plane
    more.  Given the reference's own floor(log2) the port reproduces it bit
    for bit, and both sides honour the bound."""
    tol = np.float32(2.0 ** k)
    blocks = (rng.standard_normal((64, 16)) * 2.0 ** (k + 6)).astype(np.float32)
    tols = np.full(64, tol, np.float32)
    jax_l2 = int(np.asarray(jnp.floor(jnp.log2(jnp.asarray(tol)))))
    if jax_l2 == k:
        _assert_encode_parity(blocks, tols, kernel=False)
        return
    assert jax_l2 == k - 1                              # the divergence
    want = [np.asarray(a) for a in jops.zfp_encode_blocks_fa_fast(
        jnp.asarray(blocks), jnp.asarray(tols))]
    got = _port_encode(blocks, tols)
    assert not np.array_equal(got[2], want[2])
    assert np.array_equal(got[1], want[1])
    same_l2 = ref.zfp_encode_blocks_fa_ref(
        torch.from_numpy(blocks), torch.from_numpy(tols),
        torch.full((64,), jax_l2, dtype=torch.int32))
    for a, b in zip(same_l2, want):
        assert np.array_equal(a.numpy(), b)
    for p, e, n in (got, want):
        dec = _port_decode(p, e, n)
        assert float(np.max(np.abs(dec - blocks))) <= tol


# ---------------------------------------------------------------------------
# batch API, codec seam and device-resident store
# ---------------------------------------------------------------------------

def _samples(rng, n=6, c=6, h=24, w=16):
    scales = np.logspace(-1, 1, n)
    t = np.linspace(0, 1, h)[:, None] + np.linspace(0, 1, w)[None, :]
    return np.stack([(s * (np.sin(5 * t + i) + 0.1 * rng.standard_normal((h, w))))
                     .astype(np.float32)[None].repeat(c, 0)
                     for i, s in enumerate(scales)])


def test_batch_encode_decode_matches_jax(rng):
    xs = _samples(rng)[:, :, :22, :15]                 # ragged: edge padding
    tols = np.logspace(-3, -1, len(xs)).astype(np.float32)
    want = jax_encode_batch(jnp.asarray(xs), jnp.asarray(tols))
    cf = encode_fixed_accuracy_batch(torch.from_numpy(np.ascontiguousarray(xs)),
                                     torch.from_numpy(tols))
    assert cf.shape == tuple(want.shape) and cf.padded_shape == tuple(want.padded_shape)
    for a, b in ((cf.payload, want.payload), (cf.emax, want.emax),
                 (cf.nplanes, want.nplanes)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(compressed_nbytes_batch(cf).numpy(),
                          np.asarray(jax_nbytes(want)))
    assert np.array_equal(trim_to_nplanes(cf).payload.numpy(),
                          np.asarray(jax_trim(want).payload))
    assert np.array_equal(decode_batch(cf).numpy(),
                          np.asarray(jax_decode_batch(want)))
    codec = get_codec("fixed_accuracy", tolerance=1e-2)
    cf2 = codec.encode_batch(torch.from_numpy(np.ascontiguousarray(xs)))
    assert np.array_equal(codec.decode_batch(cf2).numpy(), np.asarray(
        jax_decode_batch(jax_encode_batch(jnp.asarray(xs),
                                          jnp.full((len(xs),), 1e-2)))))


def test_device_store_get_batch_matches_jax(rng):
    xs = _samples(rng, n=8)
    tols = np.logspace(-4, -1, 8).astype(np.float32)
    jstore = JaxStore.from_samples(list(xs), tols)
    store = DeviceResidentCompressedStore.from_samples(xs, tols, device="cpu")
    assert store.payload.shape == tuple(jstore.payload.shape)
    assert store.logical_bytes == jstore.logical_bytes
    assert store.resident_bytes == jstore.resident_bytes
    assert store.ratio == pytest.approx(jstore.ratio, rel=0, abs=0)
    for idx in (np.array([3, 0, 7, 3]), np.arange(8)):
        assert np.array_equal(store.get_batch(idx).numpy(),
                              np.asarray(jstore.get_batch(idx)))


def test_codec_registry_names_the_roadmap():
    assert isinstance(get_codec("fixed_accuracy"), type(get_codec("fixed_accuracy")))
    assert get_codec("fixed_rate", bits_per_value=9).name == "fixed_rate"
    residual = get_codec("fixed_accuracy+residual", tolerance=1e-3)
    assert residual.name == "fixed_accuracy+residual" and residual.tolerance == 1e-3
    with pytest.raises(KeyError, match="unknown codec"):
        get_codec("nope")
    with pytest.raises(ValueError, match="tolerances"):
        get_codec("fixed_accuracy").encode_batch(torch.zeros(1, 4, 4))


def test_cuda_wrappers_reject_cpu_tensors_without_building():
    """The CUDA wrappers never run plain code: CPU tensors are refused
    before any build is attempted."""
    blocks = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="must be on"):
        zfp_codec.zfp_encode_blocks_fa(blocks, torch.ones(4),
                                       torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="must be on"):
        zfp_codec.zfp_decode_blocks_fa(torch.zeros(4, 3, dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="1 <= W"):
        zfp_codec.zfp_decode_blocks_fa(torch.zeros(4, 16, dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32))
    assert not zfp_codec._libs
    with pytest.raises(ValueError, match="no ZFP kernel"):
        ops.zfp_decode_blocks_fa(*(torch.zeros(2, 3, dtype=torch.int32,
                                               device="meta"),
                                   torch.zeros(2, dtype=torch.int32, device="meta"),
                                   torch.zeros(2, dtype=torch.int32, device="meta")))


# ---------------------------------------------------------------------------
# the correction loop's exact early exit (kernel 2 stops settled blocks)
# ---------------------------------------------------------------------------

def _encode_fa_early_exit(blocks, tols):
    """Plain fixed-accuracy encode that stops each block at its first
    settled pass: after a pass that finds the error within ``tol``, or once
    ``nplanes == 30``, a pass cannot change the block.  Returns payload,
    emax, nplanes and the number of passes that added planes (0..6)."""
    from repro_torch.compression.zfp import GUARD_BITS, MAX_FIX_ITERS
    b, t = torch.from_numpy(blocks), torch.from_numpy(tols)
    x, tol = T.flush_denormals(b), T.flush_denormals(t)
    emax = T.block_emax(x)
    u_full = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(x, emax)))
    npl = torch.clamp(emax - floor_log2(t) + GUARD_BITS, 0, T.TOTAL_PLANES).to(torch.int32)
    npl = torch.where((u_full == 0).all(-1), torch.zeros_like(npl), npl)
    passes = torch.zeros_like(npl)
    live = npl < T.TOTAL_PLANES
    for _ in range(MAX_FIX_ITERS):
        if not bool(live.any()):
            break
        dec = T.inv_transform_2d(T.nb2int(T.truncate_planes(u_full, npl)))
        bad = live & (T.dequantize_minus(dec, emax, x).abs().amax(-1) > tol)
        npl = torch.where(bad, torch.clamp(npl + 2, max=T.TOTAL_PLANES), npl)
        passes += bad.to(torch.int32)
        live = bad & (npl < T.TOTAL_PLANES)
    payload = T.pack_planes(T.truncate_planes(u_full, npl), T.MAX_WORDS)
    return [_np(a) for a in (payload, emax, npl, passes)]


def _pass_count_set(rng):
    """Blocks that need each of 0..6 correction passes.

    With a positive normal tolerance the guess (two guard planes) leaves at
    most two passes, except for a block whose values all lie below 2^-120:
    it codes as zero (emax 0), its error never falls, and it takes all six.
    A tolerance of -1 can never be met (floor(log2) is 0 in both packages),
    so a block at emax 28 - 2k climbs from the guess emax + 2 = 30 - 2k to
    30 planes in exactly k passes and stops there.  Also: blocks that start
    at 30 planes, all-zero and subnormal blocks, the F1 blocks."""
    rows, tols = [], []

    def add(block, tol):
        rows.append(np.asarray(block, np.float32).reshape(16))
        tols.append(tol)

    for k in range(7):
        emax = 28 - 2 * k if k < 6 else 10
        v = rng.uniform(-1, 1, 16) * 2.0 ** (emax - 1)
        v[0] = 0.75 * 2.0 ** emax
        add(v, -1.0)
    for blk in _blocks(rng, 24):                       # 0, 1 and 2 passes
        add(blk, 1e-3)
    for blk in _blocks(rng, 24, "smooth"):
        add(blk, 1e-5)
    tiny = rng.uniform(-1, 1, 16) * 2.0 ** -121        # below 2^-120: six passes
    add(tiny, 2.0 ** -126)
    add(tiny, 1e-30)                                    # error within tol: none
    add(rng.standard_normal(16), 2.0 ** -126)           # guess already 30
    add(np.zeros(16), 1e-3)
    add(np.zeros(16), -1.0)
    add(np.full(16, 1e-40), 1e-3)                       # subnormal: flushed to zero
    for blk in _f1_blocks(rng):
        add(blk, 2.0 ** -126)
        add(blk, 1e-36)
    return np.stack(rows), np.asarray(tols, np.float32)


def _assert_matches_tpu_kernel(blocks, tols):
    want = [np.asarray(a) for a in jzfp.zfp_encode_blocks_fa(
        jnp.asarray(blocks), jnp.asarray(tols), interpret=True)]
    got = _encode_fa_early_exit(blocks, tols)
    for name, a, b in zip(("payload", "emax", "nplanes"), got, want):
        assert np.array_equal(a, b), name
    full = _port_encode(blocks, tols)                  # six unconditional passes
    for a, b in zip(full, want):
        assert np.array_equal(a, b)
    return got[3]


@pytest.mark.parametrize("tol", [1e-5, 1e-3, 1e-1, "mixed"])
def test_early_exit_encode_matches_tpu_kernel(rng, tol):
    blocks = np.concatenate([_blocks(rng, 150), _blocks(rng, 150, "smooth")])
    tols = ((10.0 ** rng.uniform(-6, 0, len(blocks))) if tol == "mixed"
            else np.full(len(blocks), tol)).astype(np.float32)
    _assert_matches_tpu_kernel(blocks, tols)


def test_early_exit_encode_matches_tpu_kernel_on_pass_count_set(rng):
    _assert_matches_tpu_kernel(*_pass_count_set(rng))


def test_pass_count_set_covers_every_pass_count(rng):
    blocks, tols = _pass_count_set(rng)
    passes = _encode_fa_early_exit(blocks, tols)[3]
    assert np.array_equal(np.bincount(passes, minlength=7) > 0, np.ones(7, bool))
    assert np.array_equal(passes[:7], np.arange(7))
    npl = _encode_fa_early_exit(blocks, tols)[2]
    assert (npl[:6] == 30).all() and npl[6] == 10 + 2 + 12
