"""Tests of the PyTorch port that need a CUDA card.

They carry the ``cuda`` marker and skip where no card is present.  On a
machine with a card (no JAX needed)::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
and the simulator, the paper's forward pass and the hybrid model's prefill
on the card against the port's own CPU runs (the CPU runs are held against
the JAX package in the other ``test_torch_*`` files).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain,
)
from repro_torch.kernels.profiled_matmul import (
    profiled_matmul_cuda, profiled_matmul_plain,
)
from repro_torch.kernels.ssd_scan import (
    ssd_state_passing_cuda, ssd_state_passing_plain,
)
from repro_torch.models import attention as attn
from repro_torch.models import init_params as init_model_params
from repro_torch.models.api import model_specs
from repro_torch.models.hybrid import hybrid_hidden
from repro_torch.rinn import (
    FaultPlan, RinnConfig, ZCU102, compare, compile_graph, forward,
    generate_rinn, init_params, run_sim_batch,
)

pytestmark = pytest.mark.cuda

TABLE1 = RinnConfig(family="conv", n_backbone=8, image_size=8, filters=2,
                    kernel=3, pattern="density", density=0.35, seed=42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _operands(m, k, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32) * 0.5)
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.5)
    return a.to(device, dtype), b.to(device, dtype)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 64, 64, 64),
    (256, 512, 128, 128, 128, 256),
    (512, 256, 512, 256, 128, 256),
    (320, 192, 160, 64, 32, 64),
    (96, 40, 24, 32, 8, 8),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("profile", [True, False])
def test_kernel_matches_plain_version(cuda, m, k, n, bm, bn, bk, dtype,
                                      profile):
    a, b = _operands(m, k, n, dtype, cuda)
    kw = dict(block_m=bm, block_n=bn, block_k=bk, profile=profile)
    reset_launch_counts()
    out, prof = ops.profiled_matmul_op(a, b, **kw)
    torch.cuda.synchronize()
    name = "profiled_matmul_" + ("bf16" if dtype == torch.bfloat16 else "f32")
    assert launch_counts() == {name: 1}
    want, want_prof = profiled_matmul_plain(a, b, **kw)
    scale = float(want.float().abs().max())
    tol = 2.0 ** -7 * want.float().abs() + 1e-4 * scale
    if dtype == torch.float32:
        tol = torch.full_like(tol, 1e-4 * scale)
    assert bool(((out.float() - want.float()).abs() <= tol).all())
    if profile:
        assert prof.shape == (m // bm, n // bn)
        np.testing.assert_allclose(prof.cpu().numpy(),
                                   want_prof.cpu().numpy(),
                                   rtol=0, atol=1e-4 * scale)
    else:
        assert prof is None


def test_kernel_profile_is_from_fp32_accumulator(cuda):
    # two bf16 products whose fp32 sums differ by less than a bf16 rounding:
    # the profile must see the fp32 value, not the rounded output
    a = torch.full((64, 64), 1.0, device=cuda, dtype=torch.bfloat16)
    b = torch.full((64, 64), 1.0, device=cuda, dtype=torch.bfloat16)
    b[0, 0] = 1.0078125  # 1 + 2^-7 is exact in bf16
    out, prof = profiled_matmul_cuda(a, b, block_m=64, block_n=64,
                                     block_k=64)
    assert float(prof[0, 0]) == pytest.approx(64.0078125, abs=1e-6)
    assert float(out.float().abs().max()) == 64.0


def test_kernel_rejects_what_it_does_not_take(cuda):
    a, b = _operands(64, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        profiled_matmul_cuda(a.half(), b.half())
    with pytest.raises(ValueError):
        profiled_matmul_cuda(a.t(), b)
    with pytest.raises(ValueError):
        ops.profiled_matmul_op(a, b.cpu())
    with pytest.raises(ValueError):
        ops.profiled_matmul_op(a[:48], b, block_m=32)


def test_batch_on_card_equals_cpu(cuda):
    sim = compile_graph(generate_rinn(TABLE1), ZCU102)
    plans = [FaultPlan.generate(sim, seed=s, n_stalls=1, n_drops=s % 2,
                                n_corruptions=1, horizon=250)
             for s in range(16)]
    kw = dict(plans=plans, profiled=[s % 2 == 0 for s in range(16)],
              max_cycles=20_000)
    assert (run_sim_batch(sim, device=cuda, **kw)
            == run_sim_batch(sim, device="cpu", **kw))


def test_paper_flow_on_card_equals_cpu(cuda):
    g = generate_rinn(TABLE1)
    x = torch.linspace(-1, 1, 16)
    y, stream = forward(g, init_params(g, 3, device=cuda), x.to(cuda))
    y_cpu, stream_cpu = forward(g, init_params(g, 3, device="cpu"), x)
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=1e-5,
                               atol=1e-5)
    got, want = stream.decode(), stream_cpu.decode()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5)
    assert (compare(g, ZCU102, device=cuda).table()
            == compare(g, ZCU102, device="cpu").table())


# --------------------------------------------------------------------- #
# ssd_state_passing: bit for bit against the plain version
# --------------------------------------------------------------------- #
def _ssd_inputs(shape, device, seed=0, init=False):
    b, nc, h, p, n = shape
    g = torch.Generator().manual_seed(seed)
    states = torch.randn(shape, generator=g)
    decays = torch.sigmoid(torch.randn((b, nc, h), generator=g))
    s0 = torch.randn((b, h, p, n), generator=g) if init else None
    to = (lambda t: None if t is None else t.to(device))
    return to(states), to(decays), to(s0)


@pytest.mark.parametrize("shape", [
    (2, 32, 64, 64, 64),    # the zamba2-1.2b prefill at T = 4096
    (2, 5, 3, 7, 5),        # P*N = 35: threads cut through heads
    (1, 1, 2, 3, 3),
    (3, 9, 16, 16, 8),
])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel_equals_plain_bit_for_bit(cuda, shape, init):
    states, decays, s0 = _ssd_inputs(shape, cuda, init=init)
    reset_launch_counts()
    got = ops.ssd_state_passing_op(states, decays, head_block=shape[2],
                                   init_state=s0)
    torch.cuda.synchronize()
    assert launch_counts() == {"ssd_state_passing": 1}
    want = ssd_state_passing_plain(states, decays, head_block=shape[2],
                                   init_state=s0)
    assert got.shape == want.shape and torch.equal(got, want)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    states, decays, _ = _ssd_inputs((1, 2, 4, 4, 4), cuda)
    with pytest.raises(TypeError):
        ssd_state_passing_cuda(states.double(), decays.double())
    with pytest.raises(ValueError):
        ssd_state_passing_cuda(states.transpose(3, 4), decays)
    with pytest.raises(ValueError):
        ssd_state_passing_cuda(states, decays.cpu())
    with pytest.raises(ValueError):
        ssd_state_passing_cuda(states, decays, head_block=3)


# --------------------------------------------------------------------- #
# flash_attention
# --------------------------------------------------------------------- #
def _qkv(b, h, t, d, dtype, device, seed=0, s=None, negative=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, t, d), generator=g)
    k = torch.randn((b, h, s or t, d), generator=g)
    v = torch.randn((b, h, s or t, d), generator=g)
    if negative:   # every logit below zero: q . k < 0
        q, k = -q.abs(), k.abs()
    return (x.to(device, dtype) for x in (q, k, v))


def check_flash(out, prof, want, want_prof, dtype):
    """fp32: the kernel and the plain version sum in other orders and use
    expf on other operands (online rescaling), 2e-5.  bf16: both round the
    fp32 result once, so they may land one bf16 step apart (2^-7 relative)
    plus the fp32 difference.  Profile: the max of fp32 dot products
    summed in another order, 1e-5 relative."""
    o, r = out.float(), want.float()
    if dtype == torch.bfloat16:
        allowed = 2.0 ** -7 * r.abs() + 2e-5
    else:
        allowed = torch.full_like(r, 2e-5)
    err = (o - r).abs()
    assert bool(torch.isfinite(o).all())
    assert bool((err <= allowed).all()), float(err.max())
    if want_prof is not None:
        assert prof.shape == want_prof.shape
        np.testing.assert_allclose(prof.cpu().numpy(),
                                   want_prof.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,t,d,qb", [
    (2, 4, 256, 64, 128),   # one profile word spans two 64-row tiles
    (1, 2, 128, 128, 32),   # one tile cuts through two profile words
    (2, 3, 100, 16, 100),   # ragged T: q_block = T, a partial last tile
    (1, 2, 48, 32, 48),     # T below one tile
    (1, 1, 320, 64, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, b, h, t, d, qb, dtype, causal):
    q, k, v = _qkv(b, h, t, d, dtype, cuda, seed=t + d)
    kw = dict(causal=causal, q_block=qb, kv_block=qb)
    reset_launch_counts()
    out, prof = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == {"flash_attention": 1}
    want, want_prof = flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype and prof.shape == (b, h, t // qb)
    check_flash(out, prof, want, want_prof, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_profile_folds_negative_maxima_across_blocks(cuda, dtype):
    """Every logit is negative and each 256-row profile word spans four
    64-row CUDA blocks: the fold must keep the largest (least negative)."""
    q, k, v = _qkv(1, 2, 512, 64, dtype, cuda, seed=5, negative=True)
    out, prof = flash_attention_cuda(q, k, v, q_block=256, kv_block=256)
    want, want_prof = flash_attention_plain(q, k, v, q_block=256,
                                            kv_block=256)
    assert bool((want_prof < 0).all())
    check_flash(out, prof, want, want_prof, dtype)
    _, no_prof = flash_attention_cuda(q, k, v, profile=False)
    assert no_prof is None


def test_flash_tri_gqa_on_card_equals_cpu(cuda):
    """The model's kernel call broadcasts KV head h // G to query head h."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((2, 256, 8, 32), generator=g)
    k = torch.randn((2, 256, 2, 32), generator=g)
    v = torch.randn((2, 256, 2, 32), generator=g)
    reset_launch_counts()
    out, lmax = attn.flash_tri_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts() == {"flash_attention": 1}
    want, want_lmax = attn.naive_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert float(lmax) == pytest.approx(float(want_lmax), abs=1e-5)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 2, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v.cpu())
    q8, k8, v8 = _qkv(1, 2, 64, 8, torch.float32, cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(q8, k8, v8)            # head dim 8
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v, q_block=48)   # 64 % 48


# --------------------------------------------------------------------- #
# the hybrid prefill: card == CPU
# --------------------------------------------------------------------- #
def test_reduced_hybrid_prefill_on_card_equals_cpu(cuda):
    """zamba2-1.2b reduced, fp32, T = 128: two Mamba layers (two SSD
    kernel launches) and one shared attention site (one flash launch).
    Tolerance 1e-4: fp32 products and reductions in other orders, as the
    slice's JAX parity tests."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                              param_dtype="float32",
                              activation_dtype="float32")
    params = init_model_params(model_specs(cfg), 0, device=cuda)
    cpu = _to_cpu(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(4))
    pos = torch.arange(128)[None].expand(2, 128)
    reset_launch_counts()
    h, rows, _ = hybrid_hidden(cfg, params, toks.to(cuda), pos.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts() == {"ssd_state_passing": 2, "flash_attention": 1}
    h_cpu, rows_cpu, _ = hybrid_hidden(cfg, cpu, toks, pos)
    np.testing.assert_allclose(h.cpu().numpy(), h_cpu.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(rows.cpu().numpy(), rows_cpu.numpy(),
                               rtol=1e-4, atol=1e-4)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()
