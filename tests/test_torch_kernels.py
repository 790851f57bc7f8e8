"""Parity of the PyTorch port's kernel layer with the JAX package, on the CPU.

The plain versions (what the wrappers run for CPU tensors) are held
against the JAX package as ``tests/test_kernels.py`` runs it, with that
file's tolerances: ``profiled_matmul`` and ``ssd_state_passing`` against
the Pallas kernels in interpret mode (1e-5 in fp32, 2e-2 in bf16);
``flash_attention``, whose Pallas kernel does not trace on the installed
jax, against the ``ref.py`` oracles (2e-5 in fp32, 2e-2 in bf16, 1e-4 for
the logit-max profile).  The Hopper kernels themselves are held against
the plain versions on a card, in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.profiled_matmul import profiled_matmul as j_profiled_matmul
from repro.kernels.ssd_scan import ssd_state_passing as j_ssd_state_passing
from repro_torch.kernels import (
    build, launch_counts, ops, ref, reset_launch_counts,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain,
)
from repro_torch.kernels.profiled_matmul import (
    KERNEL, profiled_matmul_cuda, profiled_matmul_plain,
)
from repro_torch.kernels.ssd_scan import (
    ssd_state_passing_cuda, ssd_state_passing_plain,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def operands(m, k, n, dtype):
    """The same inputs for both packages, made with numpy from a seed."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    a = rng.standard_normal((m, k)).astype(np.float32) * 0.5
    b = rng.standard_normal((k, n)).astype(np.float32) * 0.5
    return ((jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)),
            (torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)))


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 64, 64, 64),
    (256, 512, 128, 128, 128, 256),
    (64, 96, 32, 256, 256, 512),   # blocks larger than the dims
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("profile", [True, False])
def test_plain_matches_pallas_interpret(m, k, n, bm, bn, bk, dtype, profile):
    (ja, jb), (ta, tb) = operands(m, k, n, dtype)
    kw = dict(block_m=bm, block_n=bn, block_k=bk, profile=profile)
    want, want_prof = j_profiled_matmul(ja, jb, interpret=True, **kw)
    reset_launch_counts()
    got, got_prof = ops.profiled_matmul_op(ta, tb, **kw)
    assert launch_counts() == {}  # CPU tensors take the plain version
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    if profile:
        assert got_prof.dtype == torch.float32
        np.testing.assert_allclose(got_prof.numpy(), np.asarray(want_prof),
                                   rtol=tol, atol=tol)
    else:
        assert got_prof is None and want_prof is None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_oracles_match(dtype):
    (ja, jb), (ta, tb) = operands(64, 32, 96, dtype)
    tol = DTYPES[dtype][2]
    want, want32 = jref.matmul_reference(ja, jb)
    got, got32 = ref.matmul_reference(ta, tb)
    assert got.dtype == ta.dtype and got32.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ref.tile_absmax_reference(ta, tb, 32, 32).numpy(),
        np.asarray(jref.tile_absmax_reference(ja, jb, 32, 32)),
        rtol=1e-5, atol=1e-5)
    # the plain version's profile is the oracle's, from the fp32 product
    _, prof = profiled_matmul_plain(ta, tb, block_m=32, block_n=32)
    assert torch.equal(prof, ref.tile_absmax_reference(ta, tb, 32, 32))


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (96, 64, 64, 64, 64, 64),
    (64, 96, 64, 64, 64, 64),
    (64, 64, 96, 64, 64, 64),
])
def test_non_divisible_dims_raise_like_reference(m, k, n, bm, bn, bk):
    (ja, jb), (ta, tb) = operands(m, k, n, "float32")
    kw = dict(block_m=bm, block_n=bn, block_k=bk)
    with pytest.raises(ValueError):
        j_profiled_matmul(ja, jb, interpret=True, **kw)
    with pytest.raises(ValueError):
        ops.profiled_matmul_op(ta, tb, **kw)
    with pytest.raises(ValueError):
        profiled_matmul_cuda(ta, tb, **kw)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version: CPU operands are
    refused before anything is built or launched."""
    (_, _), (ta, tb) = operands(64, 64, 64, "float32")
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        profiled_matmul_cuda(ta, tb)
    with pytest.raises(ValueError):
        ops.profiled_matmul_op(ta, tb[:, :32].T)  # shapes do not chain
    assert launch_counts() == {}


@pytest.mark.parametrize("name", build.KERNELS)
def test_build_names_library_by_source_and_flags(name):
    path = build.library_path(name)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    assert path == build.library_path(name)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert (build.CSRC / f"{name}.cu").exists()
    assert KERNEL in build.KERNELS


# --------------------------------------------------------------------- #
# ssd state passing
# --------------------------------------------------------------------- #
def ssd_inputs(b, nc, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((b, nc, h, p, n)).astype(np.float32) * 0.5
    decays = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, nc, h)) * 0.5))
    return states, decays.astype(np.float32)


@pytest.mark.parametrize("b,nc,h,p,n,hb", [
    (1, 4, 8, 16, 8, 4),
    (2, 8, 4, 8, 16, 4),
    (1, 2, 16, 32, 4, 8),
])
def test_ssd_plain_matches_pallas_interpret(b, nc, h, p, n, hb):
    states, decays = ssd_inputs(b, nc, h, p, n)
    want = j_ssd_state_passing(jnp.asarray(states), jnp.asarray(decays),
                               head_block=hb, interpret=True)
    reset_launch_counts()
    got = ops.ssd_state_passing_op(torch.from_numpy(states),
                                   torch.from_numpy(decays), head_block=hb)
    assert launch_counts() == {}  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == states.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ref.ssd_state_passing_reference(torch.from_numpy(states),
                                        torch.from_numpy(decays)).numpy(),
        np.asarray(jref.ssd_state_passing_reference(
            jnp.asarray(states), jnp.asarray(decays))),
        rtol=1e-5, atol=1e-5)


def test_ssd_init_state_is_the_same_recurrence():
    """A starting state s0 adds prod(decay[:c]) * s0 to every chunk's
    state: the recurrence started elsewhere, not a second path."""
    states, decays = ssd_inputs(2, 5, 4, 8, 4, seed=1)
    s0 = np.random.default_rng(2).standard_normal(
        (2, 4, 8, 4)).astype(np.float32)
    ts, td = torch.from_numpy(states), torch.from_numpy(decays)
    got = ssd_state_passing_plain(ts, td, init_state=torch.from_numpy(s0))
    base = ssd_state_passing_plain(ts, td).numpy()
    carry = np.concatenate([np.ones((2, 1, 4), np.float32),
                            np.cumprod(decays, axis=1)[:, :-1]], axis=1)
    want = base + carry[..., None, None] * s0[:, None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    zero = ssd_state_passing_plain(ts, td,
                                   init_state=torch.zeros(2, 4, 8, 4))
    assert torch.equal(zero, torch.from_numpy(base))


def test_ssd_state_passing_composes_with_model_ssd():
    """The port's kernel path plugs into the chunked SSD like the lax.scan:
    the chunk states of tests/test_kernels.py's composition case, passed by
    the Pallas kernel (interpret mode) and by the port."""
    from repro.models.ssm import ssd_reference
    rng = np.random.default_rng(3)
    b, t, h, p, n, chunk = 1, 32, 4, 8, 4, 8
    x = rng.standard_normal((b, t, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) * 0.5)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.25).astype(np.float32)
    Bm = rng.standard_normal((b, t, n)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((b, t, n)).astype(np.float32) * 0.5
    nc = t // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    cum = np.cumsum(dtc * A, axis=2)
    S = np.einsum("bcqh,bcqn,bcqhp->bchpn",
                  np.exp(cum[:, :, -1:, :] - cum) * dtc, Bc, xc)
    decay = np.exp(cum[:, :, -1, :])
    S, decay = S.astype(np.float32), decay.astype(np.float32)
    want = j_ssd_state_passing(jnp.asarray(S), jnp.asarray(decay),
                               head_block=h, interpret=True)
    got = ops.ssd_state_passing_op(torch.from_numpy(S),
                                   torch.from_numpy(decay), head_block=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the states it passes give the sequential SSD's final state
    _, s_ref = ssd_reference(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    final = decay[:, -1, :, None, None] * got.numpy()[:, -1] + S[:, -1]
    np.testing.assert_allclose(final, np.asarray(s_ref), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
def qkv(b, h, t, d, dtype, seed=0, s=None):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, t if i == 0 else (s or t), d)).astype(
        np.float32) * 0.5 for i in range(3)]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("b,h,t,d,qb,kb", [
    (1, 2, 128, 64, 64, 64),
    (2, 4, 256, 32, 128, 128),
    (1, 1, 64, 128, 32, 16),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_oracles(b, h, t, d, qb, kb, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = qkv(b, h, t, d, dtype)
    reset_launch_counts()
    out, prof = ops.flash_attention_op(tq, tk, tv, causal=causal, q_block=qb,
                                       kv_block=kb)
    assert launch_counts() == {}
    want, want_lmax = jref.mha_reference(jq, jk, jv, causal=causal)
    tol = FLASH_TOL[dtype]
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    want_prof = jref.block_logit_max_reference(jq, jk, causal=causal,
                                               q_block=qb)
    assert prof.shape == (b, h, t // qb) and prof.dtype == torch.float32
    np.testing.assert_allclose(prof.numpy(), np.asarray(want_prof),
                               rtol=1e-4, atol=1e-4)
    assert float(prof.max()) == pytest.approx(float(want_lmax), abs=1e-4)


@pytest.mark.parametrize("t", [48, 100])
def test_flash_ragged_q_block_is_t(t):
    """The model's call for T not a multiple of 128: one profile word per
    head, q_block = kv_block = T."""
    (jq, jk, jv), (tq, tk, tv) = qkv(2, 3, t, 16, "float32", seed=t)
    out, prof = ops.flash_attention_op(tq, tk, tv, q_block=t, kv_block=t)
    want, _ = jref.mha_reference(jq, jk, jv, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert prof.shape == (2, 3, 1)
    np.testing.assert_allclose(
        prof.numpy(), np.asarray(jref.block_logit_max_reference(
            jq, jk, causal=True, q_block=t)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_reference_oracles_match(dtype):
    (jq, jk, jv), (tq, tk, tv) = qkv(1, 2, 32, 16, dtype, seed=7, s=48)
    for causal in (True, False):
        want, want_lmax = jref.mha_reference(jq, jk, jv, causal=causal)
        got, got_lmax = ref.mha_reference(tq, tk, tv, causal=causal)
        tol = FLASH_TOL[dtype]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
        assert float(got_lmax) == pytest.approx(float(want_lmax), abs=1e-4)
        np.testing.assert_allclose(
            ref.block_logit_max_reference(tq, tk, causal=causal,
                                          q_block=8).numpy(),
            np.asarray(jref.block_logit_max_reference(
                jq, jk, causal=causal, q_block=8)), rtol=1e-4, atol=1e-4)


def test_flash_and_ssd_refuse_what_the_reference_refuses():
    _, (tq, tk, tv) = qkv(1, 2, 96, 16, "float32")
    with pytest.raises(ValueError):
        ops.flash_attention_op(tq, tk, tv, q_block=64)     # 96 % 64
    with pytest.raises(ValueError):
        flash_attention_cuda(tq, tk, tv, q_block=64)
    states, decays = ssd_inputs(1, 2, 6, 4, 4)
    ts, td = torch.from_numpy(states), torch.from_numpy(decays)
    with pytest.raises(ValueError):
        j_ssd_state_passing(jnp.asarray(states), jnp.asarray(decays),
                            head_block=4, interpret=True)
    with pytest.raises(ValueError):
        ops.ssd_state_passing_op(ts, td, head_block=4)     # 6 % 4
    with pytest.raises(ValueError):
        ssd_state_passing_cuda(ts, td, head_block=4)


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers never run the plain version: CPU operands are
    refused before anything is built or launched."""
    _, (tq, tk, tv) = qkv(1, 2, 64, 16, "float32")
    states, decays = ssd_inputs(1, 2, 4, 4, 4)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_state_passing_cuda(torch.from_numpy(states),
                               torch.from_numpy(decays))
    assert launch_counts() == {}
    # the plain version is the wrapper's route for CPU tensors
    out, prof = flash_attention_plain(tq, tk, tv)
    assert out.shape == tq.shape and prof.shape == (1, 2, 1)
