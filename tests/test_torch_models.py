"""Parity of the PyTorch port's hybrid model path with the JAX package, on
the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
package's parameters cross over through ``params_from_numpy``.  The
modules are compared in fp32 at 2e-5 for attention (the tolerance of
``tests/test_models.py``'s attention tests: the two sum in other orders)
and 1e-4 for the SSD paths (``test_models.py``'s SSD tolerance: the
chunked form re-associates exp-weighted sums).  The slice, at
``zamba2-1.2b.reduced()`` with T = 128 (so the shared block's attention
takes the ``flash_tri`` branch, which the reduced config's
``T <= 64`` naive cut would skip), is compared at 1e-4 in fp32 and at 2e-2
in bf16 (the bf16 tolerance of ``tests/test_kernels.py``), normwise for
bf16 activations and logits (see :func:`close_in`; measured 0.010 to
0.014) and elementwise for the fp32 profile rows.  The flash attention
kernel's plain version keeps p in fp32 where the reference's XLA form
rounds it to bf16, which the bf16 tolerance covers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.api import (
    init_caches as j_init_caches, model_specs as j_model_specs,
)
from repro.models.params import init_params as j_init_params
from repro_torch.configs import get_config, torch_dtype
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import (
    attention, common, count_params, init_params, param_bytes,
    params_from_numpy, ssm,
)
from repro_torch.models.api import (
    decode_fn, init_caches, loss_fn, make_batch, model_specs, prefill_fn,
)
from repro_torch.models.hybrid import hybrid_hidden
from repro_torch.models.params import tree_leaves

T = 128


def t_(a):
    return torch.from_numpy(np.asarray(a))


def rnd(seed, *shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def close_in(dtype, got, want, tol):
    """fp32: elementwise.  bf16: normwise, ||got - want|| <= tol ||want||.
    With 8 significant bits, and the two frameworks rounding at their own
    places (XLA's CPU bf16 products and fused elementwise chains against
    PyTorch's op-by-op rounding), single elements of a 2-layer hidden state
    drift apart by a few ulps of the tensor's scale (up to 2.3% of
    max|h| measured), while the error over the tensor stays near one ulp."""
    if dtype == "float32":
        return close(got, want, tol)
    g = got.detach().float().numpy().ravel().astype(np.float64)
    w = np.asarray(want, np.float32).ravel().astype(np.float64)
    err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    assert err <= tol, f"normwise relative error {err} > {tol}"


# --------------------------------------------------------------------- #
# common
# --------------------------------------------------------------------- #
def test_rms_norm_matches():
    x, w = rnd(0, 3, 5, 64), rnd(1, 64) + 1.0
    close(common.rms_norm(t_(x), t_(w), 1e-6),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rotary_matches(fraction):
    x = rnd(2, 2, 7, 4, 16)
    pos = np.broadcast_to(np.arange(7)[None] + 3, (2, 7)).astype(np.int32)
    close(common.apply_rotary(t_(x), t_(pos), 1e4, fraction),
          jcommon.apply_rotary(jnp.asarray(x), jnp.asarray(pos), 1e4,
                               fraction), 1e-5)


def test_activations_match():
    x = rnd(3, 1000, scale=4.0)
    close(common.gelu(t_(x)), jcommon.gelu(jnp.asarray(x)), 1e-6)
    close(common.silu(t_(x)), jcommon.silu(jnp.asarray(x)), 1e-6)
    close(common.causal_mask_bias(4, 6, 2),
          jcommon.causal_mask_bias(4, 6, 2), 0)


# --------------------------------------------------------------------- #
# attention, GQA (4 query heads over 2 KV heads)
# --------------------------------------------------------------------- #
def gqa(t, s=None, seed=0, b=2, h=4, kv=2, dh=16):
    s = s or t
    return rnd(seed, b, t, h, dh), rnd(seed + 1, b, s, kv, dh), \
        rnd(seed + 2, b, s, kv, dh)


@pytest.mark.parametrize("causal,offset", [(True, 0), (False, 0),
                                           (True, 16)])
def test_naive_attention_matches(causal, offset):
    q, k, v = gqa(16, 32 if offset else 16)
    out, lmax = attention.naive_attention(t_(q), t_(k), t_(v), causal=causal,
                                          q_offset=offset)
    want, wl = jattn.naive_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, q_offset=offset)
    close(out, want, 2e-5)
    assert float(lmax) == pytest.approx(float(wl), abs=1e-5)


@pytest.mark.parametrize("t", [128, 96])
def test_flash_tri_attention_matches(t):
    """The kernel path (its plain version on the CPU) against the
    reference's XLA form, with 128-row profile blocks (T = 128) and one
    block of T rows (T = 96)."""
    q, k, v = gqa(t, seed=4)
    reset_launch_counts()
    out, lmax = attention.flash_tri_attention(t_(q), t_(k), t_(v))
    assert launch_counts() == {}
    want, wl = jattn.flash_tri_attention(*map(jnp.asarray, (q, k, v)),
                                         q_chunk=32, kv_chunk=32)
    close(out, want, 2e-5)
    assert float(lmax) == pytest.approx(float(wl), abs=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_scan_attention_matches(causal):
    q, k, v = gqa(16, 40, seed=7)   # 40 pads to 48 with kv_chunk 16
    out, lmax = attention.flash_scan_attention(
        t_(q), t_(k), t_(v), causal=causal, q_offset=24, kv_chunk=16)
    want, wl = jattn.flash_scan_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, q_offset=24,
        kv_chunk=16)
    close(out, want, 2e-5)
    assert float(lmax) == pytest.approx(float(wl), abs=1e-5)


def test_decode_attention_matches():
    q, k, v = gqa(1, 12, seed=10)
    out, lmax = attention.decode_attention(t_(q), t_(k), t_(v), 7)
    want, wl = jattn.decode_attention(*map(jnp.asarray, (q, k, v)), 7)
    close(out, want, 2e-5)
    assert float(lmax) == pytest.approx(float(wl), abs=1e-5)


@pytest.mark.parametrize("impl,t,q_chunk", [
    ("naive", 32, 1024), ("flash_tri", 48, 8), ("flash_tri", 128, 32),
    ("flash_scan", 128, 32),
])
def test_attention_dispatch_matches(impl, t, q_chunk):
    q, k, v = gqa(t, seed=13)
    kw = dict(impl=impl, causal=True, q_chunk=q_chunk, kv_chunk=32)
    out, lmax = attention.attention(t_(q), t_(k), t_(v), **kw)
    want, wl = jattn.attention(*map(jnp.asarray, (q, k, v)), **kw)
    close(out, want, 2e-5)
    assert float(lmax) == pytest.approx(float(wl), abs=1e-5)


# --------------------------------------------------------------------- #
# SSD
# --------------------------------------------------------------------- #
def ssd_inputs(b, t, h, p, n, seed):
    x = rnd(seed, b, t, h, p)
    dt = np.log1p(np.exp(rnd(seed + 1, b, t, h)))
    A = -np.exp(rnd(seed + 2, h))
    return x, dt, A, rnd(seed + 3, b, t, n), rnd(seed + 4, b, t, n)


@pytest.mark.parametrize("t,chunk", [(32, 8), (64, 16), (24, 24)])
def test_ssd_chunked_matches(t, chunk):
    args = ssd_inputs(2, t, 3, 8, 4, seed=t)
    y, s = ssm.ssd_chunked(*map(t_, args), chunk)
    jargs = list(map(jnp.asarray, args))
    want_y, want_s = jssm.ssd_chunked(*jargs, chunk)
    ref_y, ref_s = jssm.ssd_reference(*jargs)
    for got, want in ((y, want_y), (s, want_s), (y, ref_y), (s, ref_s)):
        close(got, want, 1e-4)
    py, ps = ssm.ssd_reference(*map(t_, args))
    close(py, ref_y, 1e-4)
    close(ps, ref_s, 1e-4)


def test_ssd_chunked_init_state_matches():
    """Two halves with the state carried equal the whole, and the port's
    starting-state run equals the reference's."""
    x, dt, A, Bm, Cm = ssd_inputs(1, 16, 2, 4, 4, seed=20)
    s1 = t_(rnd(25, 1, 2, 4, 4))
    y2, st2 = ssm.ssd_chunked(*map(t_, (x, dt, A, Bm, Cm)), 8, init_state=s1)
    wy2, ws2 = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 8,
                                init_state=jnp.asarray(s1.numpy()))
    close(y2, wy2, 1e-4)
    close(st2, ws2, 1e-4)
    ry, rs = jssm.ssd_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                init_state=jnp.asarray(s1.numpy()))
    close(y2, ry, 1e-4)
    close(st2, rs, 1e-4)
    y_full, s_full = ssm.ssd_chunked(*map(t_, (x, dt, A, Bm, Cm)), 8)
    ya, sa = ssm.ssd_chunked(*(t_(a[:, :8]) if a.ndim > 1 else t_(a)
                               for a in (x, dt, A, Bm, Cm)), 8)
    yb, sb = ssm.ssd_chunked(*(t_(a[:, 8:]) if a.ndim > 1 else t_(a)
                               for a in (x, dt, A, Bm, Cm)), 8, init_state=sa)
    close(torch.cat([ya, yb], 1), y_full.numpy(), 1e-4)
    close(sb, s_full.numpy(), 1e-4)


@pytest.fixture(scope="module")
def ssm_case():
    cfg = dataclasses.replace(j_get_config("zamba2-1.2b").reduced(),
                              param_dtype="float32",
                              activation_dtype="float32")
    jp = j_init_params(jssm.ssm_specs(cfg), jax.random.PRNGKey(3))
    return cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def test_ssm_block_apply_matches(ssm_case):
    cfg, jp, tp = ssm_case
    x = rnd(30, 2, 32, cfg.d_model)
    out, prof = ssm.ssm_block_apply(cfg, tp, t_(x))
    want, wprof = jax.jit(functools.partial(jssm.ssm_block_apply, cfg))(
        jp, jnp.asarray(x))
    close(out, want, 1e-4)
    close(prof["state_rms"], wprof["state_rms"], 1e-4)


def test_ssm_block_decode_matches(ssm_case):
    cfg, jp, tp = ssm_case
    cache = ssm.ssm_cache_init(cfg, 2, torch.float32)
    jcache = jssm.ssm_cache_init(cfg, 2, jnp.float32)
    step = jax.jit(functools.partial(jssm.ssm_block_decode, cfg))
    for i in range(3):
        x = rnd(40 + i, 2, 1, cfg.d_model)
        out, cache, prof = ssm.ssm_block_decode(cfg, tp, t_(x), cache)
        want, jcache, wprof = step(jp, jnp.asarray(x), jcache)
        close(out, want, 1e-4)
        close(prof["state_rms"], wprof["state_rms"], 1e-4)
        for got, w in zip(cache, jcache):
            close(got, w, 1e-4)


# --------------------------------------------------------------------- #
# the slice: zamba2-1.2b reduced, T = 128
# --------------------------------------------------------------------- #
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_STEPS = 5


def slice_cfgs(dtype):
    base = dict(param_dtype=dtype, activation_dtype=dtype)
    return (dataclasses.replace(j_get_config("zamba2-1.2b").reduced(), **base),
            dataclasses.replace(get_config("zamba2-1.2b").reduced(), **base))


@pytest.fixture(scope="module", params=list(SLICE_TOL))
def hybrid_case(request):
    """The JAX side of the slice, computed once per dtype."""
    dtype = request.param
    jcfg, cfg = slice_cfgs(dtype)
    jp = j_init_params(j_model_specs(jcfg), jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, T)).astype(np.int32)
    jt = jnp.asarray(toks)
    pos = jnp.broadcast_to(jnp.arange(T)[None], (2, T))
    h, rows, _ = jax.jit(functools.partial(jhybrid.hybrid_hidden, jcfg))(
        jp, jt, pos)
    # the reference's prefill_fn is h[:, -1:] of this hidden state and its
    # loss_fn the chunked CE of it (api.py:58-62, hybrid.py:123-128); both
    # are taken from the one compiled hidden state to keep the test short
    ce = jax.jit(functools.partial(jtransformer.chunked_ce_loss, jcfg))(
        jp, h, jt)
    step = jax.jit(functools.partial(jhybrid.hybrid_decode_step, jcfg))
    jc = j_init_caches(jcfg, 2, 8)
    dec = []
    for i in range(DECODE_STEPS):
        lg, jc, drows = step(jp, jc, jt[:, i:i + 1], i)
        dec.append((np.asarray(lg, np.float32), np.asarray(drows)))
    host = jax.tree_util.tree_map(np.asarray, jp)
    return dict(dtype=dtype, cfg=cfg, tol=SLICE_TOL[dtype], toks=toks,
                params=params_from_numpy(host, device="cpu"),
                h=np.asarray(h, np.float32), rows=np.asarray(rows),
                last=np.asarray(h[:, -1:], np.float32), loss=float(ce),
                ce=float(ce), dec=dec)


def test_hybrid_hidden_matches(hybrid_case):
    c = hybrid_case
    toks = torch.from_numpy(c["toks"]).long()
    pos = torch.arange(T)[None].expand(2, T)
    reset_launch_counts()
    h, rows, aux = hybrid_hidden(c["cfg"], c["params"], toks, pos)
    assert launch_counts() == {}  # CPU tensors: the kernels' plain versions
    assert h.dtype == torch_dtype(c["dtype"]) and h.shape == (2, T, 64)
    close_in(c["dtype"], h, c["h"], c["tol"])
    # profile rows: act_rms, act_absmax, attn_logit_max, state_rms per layer;
    # layer 0 has no shared site (-1e30), layer 1 has one
    assert rows.shape == c["rows"].shape == (2, 4)
    close(rows, c["rows"], c["tol"])
    assert float(rows[0, 2]) == np.float32(-1e30)
    assert float(rows[1, 2]) > -1e29
    assert float(aux) == 0.0


def test_prefill_fn_matches(hybrid_case):
    c = hybrid_case
    last, caches = prefill_fn(c["cfg"], c["params"],
                              {"tokens": torch.from_numpy(c["toks"]).long()})
    assert caches is None
    assert last.shape == (2, 1, 64)
    close_in(c["dtype"], last, c["last"], c["tol"])


def test_hybrid_loss_matches(hybrid_case):
    c = hybrid_case
    toks = torch.from_numpy(c["toks"]).long()
    loss, (ce, rows) = loss_fn(c["cfg"], c["params"],
                               {"tokens": toks, "labels": toks})
    assert float(loss) == pytest.approx(c["loss"], rel=c["tol"])
    assert float(ce) == pytest.approx(c["ce"], rel=c["tol"])
    close(rows, c["rows"], c["tol"])


def test_hybrid_decode_steps_match(hybrid_case):
    c = hybrid_case
    toks = torch.from_numpy(c["toks"]).long()
    caches = init_caches(c["cfg"], 2, 8, device="cpu")
    assert caches.shared_k.shape == (1, 2, 8, 2, 16)
    for i, (want_lg, want_rows) in enumerate(c["dec"]):
        lg, caches, rows = decode_fn(c["cfg"], c["params"], caches,
                                     toks[:, i:i + 1], i)
        assert lg.shape == (2, 1, 256) and rows.shape == (3,)
        close_in(c["dtype"], lg, want_lg, c["tol"])
        close(rows, want_rows, c["tol"])
    assert caches.window_pos == DECODE_STEPS


@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_matches_spec_tree(reduced):
    jcfg = j_get_config("zamba2-1.2b")
    cfg = get_config("zamba2-1.2b")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jspecs, specs = j_model_specs(jcfg), model_specs(cfg)
    want = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "axes"))
    got = list(tree_leaves(specs))
    assert len(got) == len(want)
    for g, (_, w) in zip(got, want):
        assert g.shape == w.shape and g.axes == w.axes and g.init == w.init
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
    from repro.models.params import count_params as jcount, param_bytes as jb
    assert count_params(specs) == jcount(jspecs)
    assert param_bytes(specs) == jb(jspecs)
    if reduced:
        params = init_params(specs, 0, device="cpu")
        leaves = list(tree_leaves(params))
        jvals = jax.tree_util.tree_leaves(
            j_init_params(jspecs, jax.random.PRNGKey(0)))
        for p, j in zip(leaves, jvals):
            assert tuple(p.shape) == j.shape
            assert str(p.dtype).split(".")[-1] == j.dtype.name
        # the same seed gives the same parameters
        again = list(tree_leaves(init_params(specs, 0, device="cpu")))
        assert all(torch.equal(a, b) for a, b in zip(leaves, again))
    else:
        assert count_params(specs) == 1_170_473_856


def test_other_families_name_their_slice():
    for arch in ("qwen2.5-14b", "moonshot-v1-16b-a3b", "mamba2-780m",
                 "whisper-base"):
        with pytest.raises(NotImplementedError, match="slice"):
            model_specs(get_config(arch).reduced())
    batch = make_batch(get_config("zamba2-1.2b").reduced(), 2, 8,
                       device="cpu")
    assert batch["tokens"].shape == (2, 8)
    assert torch.equal(batch["tokens"], batch["labels"])
