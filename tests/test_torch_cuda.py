"""Tests of the PyTorch port that need a CUDA card.

They carry the ``cuda`` marker and skip where no card is present.  On a
machine with a card (no JAX needed)::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same inputs,
and the simulator and forward pass on the card against the port's own CPU
runs (the CPU runs are held against the JAX package in the other
``test_torch_*`` files).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels.profiled_matmul import (
    profiled_matmul_cuda, profiled_matmul_plain,
)
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
