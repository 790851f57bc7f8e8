"""Parity of the PyTorch port's kernel layer with the JAX package, on the CPU.

The plain version of ``profiled_matmul`` (what the wrapper runs for CPU
tensors) is held against the Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it, with that file's tolerances: 1e-5 in
fp32 and 2e-2 in bf16.  The Hopper kernel itself is held against the plain
version on a card, in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.profiled_matmul import profiled_matmul as j_profiled_matmul
from repro_torch.kernels import (
    build, launch_counts, ops, ref, reset_launch_counts,
)
from repro_torch.kernels.profiled_matmul import (
    KERNEL, profiled_matmul_cuda, profiled_matmul_plain,
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


def test_build_names_library_by_source_and_flags():
    path = build.library_path("profiled_matmul")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("profiled_matmul-") and path.suffix == ".so"
    assert path == build.library_path("profiled_matmul")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert (build.CSRC / f"{KERNEL}.cu").exists()
