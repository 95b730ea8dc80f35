"""The port's flash attention (plain version and dispatch) against the JAX
package's TPU kernel (interpret mode) and its oracle.

Inputs are made with numpy from a seed and given to both packages.  The
plain version sums in another order than the kernel's online softmax, so
values are held to the tolerances of ``tests/test_kernels.py``: f32 2e-5,
bf16 3e-2.  The per-row key lengths (``kv_lens``) that serve the decode
path are held against the reference LM's own ``attention`` call, built as
``lm.py:549-557`` builds it, and against the oracle on each row's prefix.
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import lm

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}

CASES = [
    # b, hq, hkv, sq, sk, d, causal, window, dtype
    (2, 4, 2, 64, 64, 32, True, None, "float32"),
    (1, 8, 2, 1, 128, 64, True, None, "float32"),      # decode shape
    (1, 4, 4, 96, 96, 16, False, None, "float32"),     # encoder (full)
    (2, 2, 1, 128, 128, 32, True, 48, "float32"),      # sliding window
    (1, 4, 2, 256, 256, 64, True, None, "bfloat16"),   # bf16
    (1, 2, 2, 80, 80, 24, True, None, "float32"),      # pad-needing shape
    # Sq < Sk: queries end-aligned with the keys
    (2, 4, 2, 24, 80, 32, True, None, "float32"),
    (1, 6, 3, 7, 50, 16, False, None, "float32"),
    (2, 4, 1, 40, 100, 32, True, 30, "float32"),
    (1, 4, 2, 33, 160, 64, True, None, "bfloat16"),
]


def _inputs(seed, b, hq, hkv, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    tt = getattr(torch, dtype)
    return jx, [torch.from_numpy(a).to(tt) for a in (q, k, v)]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:6])) +
                         f"-{'causal' if c[6] else 'full'}-w{c[7]}-{c[8]}")
def test_plain_matches_tpu_kernel_and_oracle(case):
    b, hq, hkv, sq, sk, d, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(0, b, hq, hkv, sq, sk, d, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (b, hq, sq, d)
    want_kernel = jax_flash(jq, jk, jv, causal=causal, window=window, interpret=True)
    want_oracle = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want_kernel), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_oracle), atol=ATOL[dtype])


def test_plain_matches_small_block_kernel():
    """Blocks smaller than the defaults exercise the TPU kernel's carry."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 2, 2, 64, 64, 16, "float32")
    want = jax_flash(jq, jk, jv, causal=True, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(_np(ops.flash_attention(q, k, v)), _np(want), atol=2e-5)
    want = jax_flash(jq, jk, jv, causal=True, window=20, block_q=16, block_k=16,
                     interpret=True)
    np.testing.assert_allclose(_np(ops.flash_attention(q, k, v, window=20)), _np(want),
                               atol=2e-5)


def test_sm_scale_is_passed_through():
    (jq, jk, jv), (q, k, v) = _inputs(2, 1, 4, 2, 16, 48, 32, "float32")
    want = jax_flash(jq, jk, jv, causal=True, sm_scale=0.37, interpret=True)
    np.testing.assert_allclose(_np(ops.flash_attention(q, k, v, sm_scale=0.37)),
                               _np(want), atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 9)])
def test_kv_lens_rows_match_the_oracle_on_their_prefix(causal, window):
    """Row b with kv_lens[b] keys == the oracle on keys[:kv_lens[b]]."""
    b, hq, hkv, sq, sk, d = 4, 4, 2, 3, 40, 32
    (jq, jk, jv), (q, k, v) = _inputs(3, b, hq, hkv, sq, sk, d, "float32")
    lens = np.array([3, 17, 40, 26], np.int32)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_lens=torch.from_numpy(lens))
    for i, n in enumerate(lens):
        want = jax_ref.flash_attention_ref(jq[i:i + 1], jk[i:i + 1, :, :n],
                                           jv[i:i + 1, :, :n], causal=causal,
                                           window=window)
        np.testing.assert_allclose(_np(got[i:i + 1]), _np(want), atol=2e-5)


@pytest.mark.parametrize("dtype,s", [("float32", 1), ("float32", 3), ("bfloat16", 1)])
def test_kv_lens_match_the_reference_decode_attention(dtype, s):
    """The port's LM attention on the cache with kv_lens == pos + s equals
    the reference's ``attention`` call of its cached decode (lm.py:549-557):
    per-slot positions, keys past each slot's last position moved to 2**30,
    the cache rounded to q's dtype."""
    jlm = load_reference().lm
    rng = np.random.default_rng(4)
    b, h, hkv, d, max_seq = 4, 4, 2, 32, 48
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ck = rng.standard_normal((b, max_seq, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, max_seq, hkv, d)).astype(np.float32)
    pos = np.array([0, 5, 44, 21], np.int32)[:, None] + np.arange(s, dtype=np.int32)
    jq = jnp.asarray(q, dtype)
    kpos = jnp.broadcast_to(jnp.arange(max_seq, dtype=jnp.int32)[None], (b, max_seq))
    valid = kpos <= jnp.asarray(pos)[:, -1:]
    want = jlm.attention(jq, jnp.asarray(ck).astype(jq.dtype),
                         jnp.asarray(cv).astype(jq.dtype), jnp.asarray(pos),
                         jnp.where(valid, kpos, jnp.int32(2 ** 30)), causal=True,
                         chunk=64, seq_sharded=s == 1)
    got = lm.attention(torch.from_numpy(q).to(getattr(torch, dtype)), torch.from_numpy(ck),
                       torch.from_numpy(cv), causal=True,
                       kv_lens=torch.from_numpy(pos[:, -1] + 1))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype])


def test_dispatch_rejects_other_devices_and_bad_shapes():
    meta = [torch.zeros(1, 2, 3, 8, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="no attention kernel"):
        ops.flash_attention(*meta)
    q, k = torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, k)
    q, k = torch.zeros(1, 2, 5, 8), torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(k, k, k, window=0)
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(k, k, k, kv_lens=torch.ones(1, dtype=torch.int32,
                                                       device="meta"))


def test_cuda_wrapper_takes_only_card_tensors_and_builds_nothing():
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="must be on the card"):
        fa.flash_attention(x, x, x)
    assert not fa._libs


def test_card_tensors_go_to_the_kernel_never_to_plain_code(monkeypatch):
    """Tensors that are not on the CPU reach the kernel's wrapper; the plain
    version is not called and no error is swallowed."""
    calls = []
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts, kind: False)
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda *a, **kw: pytest.fail("plain version called"))
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: calls.append(kw) or "k")
    x = torch.zeros(1, 2, 4, 8)
    assert ops.flash_attention(x, x, x, window=3) == "k"
    assert calls == [{"causal": True, "sm_scale": None, "window": 3, "kv_lens": None}]

    def broken(*a, **kw):
        raise RuntimeError("flash_attention launch failed with CUDA error 1")

    monkeypatch.setattr(fa, "flash_attention", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.flash_attention(x, x, x)


# --- choosing the kernel: select_variant, the split plan, the launch ------------

def _t(shape, dtype, *, pad=0, offset=0):
    """A tensor of ``shape`` whose rows (last dim) are padded by ``pad``
    elements and whose base pointer is ``offset`` elements past an aligned
    allocation."""
    *lead, d = shape
    n = int(np.prod(lead)) * (d + pad) + offset
    base = torch.zeros(n, dtype=getattr(torch, dtype))[offset:]
    return base.view(*lead, d + pad)[..., :d]


def _qkv(b, hq, hkv, sq, sk, d, qdt="bfloat16", kvdt=None, **kw):
    kvdt = kvdt or qdt
    return (_t((b, hq, sq, d), qdt, **kw), _t((b, hkv, sk, d), kvdt, **kw),
            _t((b, hkv, sk, d), kvdt, **kw))


LENS = torch.ones(2, dtype=torch.int32)

VARIANT_TABLE = [
    # (b, hq, hkv, sq, sk, d, q dtype, kv dtype, kv_lens, window, layout kw), variant
    ((1, 16, 8, 1024, 1024, 128, "bfloat16", None, None, None, {}), "prefill_wgmma"),
    ((2, 4, 2, 80, 80, 64, "bfloat16", None, None, 48, {}), "prefill_wgmma"),
    ((1, 4, 2, 9, 40, 128, "bfloat16", None, None, None, {}), "prefill_wgmma"),
    ((1, 4, 2, 64, 64, 32, "bfloat16", None, None, None, {}), "scalar"),
    ((1, 2, 2, 80, 80, 24, "bfloat16", None, None, None, {}), "scalar"),
    ((1, 4, 2, 64, 64, 128, "float32", None, None, None, {}), "scalar"),
    ((2, 2, 1, 128, 128, 32, "float32", None, None, 48, {}), "scalar"),
    ((1, 4, 2, 64, 64, 128, "bfloat16", "float32", None, None, {}), "scalar"),
    ((2, 4, 2, 16, 64, 128, "bfloat16", None, LENS, None, {}), "scalar"),
    ((1, 4, 2, 64, 64, 128, "bfloat16", None, None, None, {"pad": 4}), "scalar"),
    ((1, 4, 2, 64, 64, 128, "bfloat16", None, None, None, {"offset": 1}), "scalar"),
    ((2, 16, 8, 1, 1088, 128, "bfloat16", "float32", LENS, None, {}), "decode_splitkv"),
    ((1, 8, 2, 1, 128, 64, "float32", None, None, None, {}), "decode_splitkv"),
    ((2, 4, 2, 3, 40, 32, "float32", None, LENS, 9, {}), "decode_splitkv"),
    ((2, 64, 8, 8, 300, 128, "bfloat16", "float32", LENS, None, {}), "decode_splitkv"),
    ((2, 8, 8, 1, 129, 128, "bfloat16", "bfloat16", LENS, None, {}), "decode_splitkv"),
    ((1, 8, 2, 1, 40, 24, "float32", None, None, None, {}), "decode_splitkv"),
    ((1, 8, 2, 1, 40, 20, "bfloat16", None, None, None, {}), "scalar"),
    ((2, 128, 8, 8, 64, 128, "bfloat16", "float32", LENS, None, {}), "scalar"),
    ((1, 8, 2, 1, 64, 128, "bfloat16", "float32", None, None, {"pad": 2}), "scalar"),
    ((1, 8, 2, 1, 64, 128, "bfloat16", "float32", None, None, {"offset": 2}), "scalar"),
] + [((2, 16, 8, sq, 64, 128, "bfloat16", "float32", lens, None, {}), "decode_splitkv")
     for sq in range(1, 9) for lens in (None, LENS)]


@pytest.mark.parametrize("case,want", VARIANT_TABLE, ids=lambda c: (
    "x".join(map(str, c[:6])) + f"-{c[6]}-{c[7]}-lens{c[8] is not None}-w{c[9]}-"
    + "".join(f"{k}{v}" for k, v in c[10].items())) if isinstance(c, tuple) else c)
def test_select_variant_is_a_rule_on_dtypes_shapes_strides_alignment(case, want):
    b, hq, hkv, sq, sk, d, qdt, kvdt, lens, window, kw = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, qdt, kvdt, **kw)
    assert fa.select_variant(q, k, v, lens, window) == want
    # pure: the same answer again, and the inputs untouched
    assert fa.select_variant(q, k, v, lens, window) == want
    assert not q.any() and not k.any()


@pytest.mark.parametrize("b,hkv", [(1, 1), (8, 8), (1, 8), (64, 8)])
@pytest.mark.parametrize("sk", [1, 127, 128, 129, 1088])
def test_split_plan_and_scratch_cover_every_key(b, hkv, sk):
    splits, keys = fa.split_plan(b, hkv, sk)
    assert keys in fa.SPLIT_KEYS and keys % fa.DECODE_TILE == 0
    assert splits * keys >= sk and (splits - 1) * keys < max(sk, 1)
    # as many CTAs as the card has SM pairs, unless even the shortest split
    # cannot give them
    assert b * hkv * splits >= fa.MIN_CTAS or keys == fa.SPLIT_KEYS[-1]
    if (b, hkv, sk) == (8, 8, 1088):
        assert (splits, keys) == (9, 128)          # 576 CTAs at the serving shape
    ml, acc = fa.decode_scratch_shapes(b, 2 * hkv, 3, 64, splits)
    assert ml == (2, b, 2 * hkv, 3, splits) and acc == (b, 2 * hkv, 3, splits, 64)


class _FakeLib:
    """Stands in for the built library: records each call's arguments."""

    def __init__(self, ret=0):
        self.ret, self.calls = ret, []

    def flash_attention_launch(self, *args):
        self.calls.append(args)
        return self.ret


def _fake(monkeypatch, ret=0):
    lib = _FakeLib(ret)
    monkeypatch.setattr(fa, "build", lambda: {"flash_attention": lib})
    monkeypatch.setattr(fa, "_require_card", lambda *a: None)
    monkeypatch.setattr(fa, "_current_stream", lambda dev: 0)
    return lib


# argument positions of flash_attention_launch
_SQ, _VARIANT, _ML, _ACC, _SPLITS, _SPLIT_KEYS = 8, 17, 18, 19, 20, 21


@pytest.mark.parametrize("case,want", [VARIANT_TABLE[0], VARIANT_TABLE[3],
                                       VARIANT_TABLE[11], VARIANT_TABLE[13]],
                         ids=["prefill", "scalar", "decode", "decode-sq3"])
def test_wrapper_passes_the_chosen_variant_and_its_scratch(monkeypatch, case, want):
    b, hq, hkv, sq, sk, d, qdt, kvdt, lens, window, kw = case
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, qdt, kvdt, **kw)
    lib = _fake(monkeypatch)
    shapes = []
    real = fa.decode_scratch_shapes
    monkeypatch.setattr(fa, "decode_scratch_shapes",
                        lambda *a: shapes.append(real(*a)) or shapes[-1])
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, window=window, kv_lens=lens)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.transpose(1, 2).is_contiguous()
    (args,) = lib.calls
    assert args[_VARIANT] == fa._VARIANT_CODE[want] and args[_SQ] == sq
    if want == "decode_splitkv":
        splits, keys = fa.split_plan(b, hkv, sk)
        assert (args[_SPLITS], args[_SPLIT_KEYS]) == (splits, keys)
        assert shapes == [((2, b, hq, sq, splits), (b, hq, sq, splits, d))]
        assert args[_ML] and args[_ACC] and args[_ML] != args[_ACC]
    else:
        assert args[_ML] is None and args[_ACC] is None and not shapes
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.VARIANT_LAUNCHES == {v_: int(v_ == want) for v_ in fa.VARIANTS}


def test_wrapper_raises_on_a_failed_launch_and_counts_nothing(monkeypatch):
    q, k, v = _qkv(1, 16, 8, 1024, 1024, 128)
    lib = _fake(monkeypatch, ret=1)
    fa.reset_launches()
    with pytest.raises(RuntimeError, match=r"prefill_wgmma\) launch failed with CUDA error 1"):
        fa.flash_attention(q, k, v)
    assert len(lib.calls) == 1 and fa.LAUNCHES["flash_attention"] == 0
    assert not any(fa.VARIANT_LAUNCHES.values())


@pytest.mark.parametrize("variant", ["prefill_wgmma", "decode_splitkv", "flash"])
def test_a_variant_whose_preconditions_fail_raises(monkeypatch, variant):
    """f32 q with 64 head dims and 16 rows of 68 elements per KV head (not
    16-byte aligned in bf16): neither new kernel takes it, and naming one
    raises before anything is launched."""
    q, k, v = _qkv(1, 128, 1, 16, 64, 64, "float32", "bfloat16", pad=2)
    lib = _fake(monkeypatch)
    assert fa.select_variant(q, k, v, None, None) == "scalar"
    with pytest.raises(ValueError, match="does not take|must be one of"):
        fa._launch(q, k, v, causal=True, sm_scale=None, window=None, kv_lens=None,
                   variant=variant)
    assert not lib.calls
    fa._launch(q, k, v, causal=True, sm_scale=None, window=None, kv_lens=None,
               variant="scalar")
    assert lib.calls[0][_VARIANT] == 0


# the partial entry: one shard of a sequence-sharded cache
_Q_SHIFT, _LSE = 22, 23


@pytest.mark.parametrize("sq,causal,window", [(1, True, None), (3, True, None),
                                              (8, True, 5), (2, False, None)])
@pytest.mark.parametrize("shards,end_back", [(2, 0), (3, 5), (4, 11)])
def test_partial_attention_over_key_shards_merges_to_the_whole(sq, causal, window, shards,
                                                               end_back):
    """Each shard of the keys through the plain partial version (its keys
    past ``end`` cut by ``kv_lens``, its queries moved past the shard's keys
    by ``q_shift``), merged by the log-sum-exps as the sharded decode
    merges them, equals the plain attention over the first ``end`` keys;
    a shard past ``end`` contributes nothing."""
    b, hq, hkv, d, sl = 2, 4, 2, 16, 8
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, hq, sq, d), (b, hkv, sl * shards, d), (b, hkv, sl * shards, d)))
    end = sl * shards - end_back
    want = ref.flash_attention_ref(q, k[:, :, :end], v[:, :, :end], causal=causal,
                                   window=window)
    outs, lses = [], []
    for r in range(shards):
        k0 = r * sl
        n = min(max(end - k0, 0), sl)
        o, lse = ops.flash_attention_partial(
            q, k[:, :, k0:k0 + sl], v[:, :, k0:k0 + sl], causal=causal, window=window,
            kv_lens=torch.full((b,), n, dtype=torch.int32), q_shift=max(end - k0 - n, 0))
        assert o.dtype == lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
        if n == 0:
            assert bool((lse == -1e30).all()) and not bool(o.any())
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(0))
    got = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL["float32"])


def test_partial_entry_passes_its_shift_and_lse_and_takes_decode_inputs_only(monkeypatch):
    q, k, v = _qkv(2, 16, 8, 1, 1088, 128, "bfloat16", "float32")
    lens = torch.full((2,), 500, dtype=torch.int32)
    lib = _fake(monkeypatch)
    fa.reset_launches()
    out, lse = fa.flash_attention_partial(q, k, v, kv_lens=lens, q_shift=7)
    (args,) = lib.calls
    assert args[_VARIANT] == fa._VARIANT_CODE["decode_splitkv"] and args[_Q_SHIFT] == 7
    assert args[_LSE] == lse.data_ptr() and args[3] == out.data_ptr()
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == (2, 16, 1)
    assert fa.VARIANT_LAUNCHES["decode_splitkv"] == 1
    assert fa.PARTIAL_LAUNCHES["flash_attention_partial"] == 1
    fa.flash_attention(q, k, v, kv_lens=lens)
    assert lib.calls[1][_Q_SHIFT] == 0 and lib.calls[1][_LSE] is None
    assert fa.VARIANT_LAUNCHES["decode_splitkv"] == 2
    assert fa.PARTIAL_LAUNCHES["flash_attention_partial"] == 1
    with pytest.raises(ValueError, match="split-KV decode's inputs only"):
        fa.flash_attention_partial(*_qkv(1, 16, 8, 1024, 1024, 128))
    with pytest.raises(ValueError, match="q_shift"):
        fa.flash_attention_partial(q, k, v, kv_lens=lens, q_shift=-1)
    assert len(lib.calls) == 2
