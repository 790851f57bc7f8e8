#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA.  It imports nothing of JAX
or of the JAX package.  Phases, each of which raises on failure:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the port from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` for ``sm_90a`` (into ``build/kernels/``), one
   ``nvcc`` per source, all started together, timed;
3. kernel layer: ``profiled_matmul_op`` at M = N = K = 4096 in bf16 and fp32
   with the default 256/256/512 blocks, a profile tile (256x128) that spans
   several CUDA blocks, a small shape whose profile tiles cut through the
   CUDA blocks, and ``profile=False``; ``ssd_state_passing_op`` at the
   zamba2-1.2b prefill's [2, 32, 64, 64, 64], with a starting state, and at
   a small shape whose P*N is not a multiple of the CUDA block;
   ``flash_attention_op`` at the prefill's [2, 32, 4096, 64] in bf16 causal
   and fp32 causal and non-causal, plus a profile word that spans several
   CUDA blocks and whose maxima are all negative.  Launch counts are zeroed
   just before these calls and read just after; every output and profile
   is then held against the plain PyTorch version on the same inputs, and
   the kernel, the plain version and the library yardstick where there is
   one (``torch.matmul``, ``scaled_dot_product_attention``; the port never
   calls them) are timed with CUDA events;
4. paper flow on the card: ``generate_rinn`` -> ``init_params``/``forward``
   with the in-band profile stream -> ``ProfileCollector.ingest`` ->
   ``compare(graph, ZCU102)`` for the Table-I design and the end-to-end test
   design.  The Table-I integers must equal the JAX reference's, and the
   forward output and every decoded profile label must equal a CPU run;
5. fault campaign: 1024 seeded fault-plan lanes of the Table-I machine in
   one ``run_sim_batch`` on the card, every ``SimResult`` field equal to the
   port's CPU run of the same lanes; then the same batch in parts (host
   packing, ``_simulate`` alone, copy back and unpacking) and the card's
   busy time during ``_simulate`` from ``torch.profiler``;
6. hybrid serving at full width: ``zamba2-1.2b`` (38 Mamba2 layers, the
   shared attention block at 6 sites) initialised on the card in bf16 from a
   seed; one ``prefill_fn`` on [2, 4096] seeded tokens with the launch
   counts zeroed just before and read just after (38 ``ssd_state_passing``
   and 6 ``flash_attention`` launches); three warm prefills timed with CUDA
   events; a ``torch.profiler`` breakdown of one prefill; the same prefill
   at full width, depth 6 (one shared site), T = 512 in fp32 on the card
   against the host CPU; then ``run_serve(..., reduced=False)`` with batch
   4, 16 prompt and 16 generated tokens, clean and with ``corrupt_every=1``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a card, or outside
a checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

GEMM = 4096
CAMPAIGN_LANES = 1024
ARCH = "zamba2-1.2b"
PREFILL = (2, 4096)                 # the full-width prefill's [B, T]
SSD_SHAPE = (2, 32, 64, 64, 64)     # its chunk states: T / 128 chunks, H, P, N
FLASH_SHAPE = (2, 32, 4096, 64)     # its shared attention: [B, H, T, Dh]
EXACT = dict(n_layers=6, batch=1, seq=512)
SERVE = dict(batch=4, prompt_len=16, gen=16)

# (name, RinnConfig kwargs, compare kwargs, integers of the JAX reference on
# the CPU): the Table-I design of benchmarks/table1_cosim.py and the design
# of tests/test_system.py::test_paper_flow_end_to_end.  ``sum_abs_diff`` is
# mean|diff| times the signal count (1.05 * 20 and 3/7 * 14).
PAPER_FLOW = (
    ("table1",
     dict(family="conv", n_backbone=8, image_size=8, filters=2, kernel=3,
          pattern="density", density=0.35, merge_op="add", seed=42),
     dict(auto_remediate=True),
     dict(n_signals=20, sum_abs_diff=21, max_abs_diff=3, min_depth=1,
          max_depth=64, cycles_unprofiled=234, cycles_profiled=251,
          remediation_attempts=0)),
    ("paper_flow_end_to_end",
     dict(n_backbone=5, image_size=6, seed=2, pattern="long_skip",
          density=0.5),
     dict(),
     dict(n_signals=14, sum_abs_diff=6, max_abs_diff=2, min_depth=1,
          max_depth=35, cycles_unprofiled=124, cycles_profiled=130,
          remediation_attempts=0)),
)


def say(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------- #
# phase 3: the kernel layer
# --------------------------------------------------------------------- #
def gemm_bound_ms(m: int, n: int, k: int, dtype, prof_words: int) -> tuple:
    """The least time the card could take for one profiled product: the
    larger of its bytes (inputs read once, outputs written once) over the
    memory rate and its FLOP over the peak rate of the input type."""
    import torch

    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (m * k + k * n + m * n) * item + 4 * prof_words
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / PEAK_OPS_PER_S[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def check_gemm(out, prof, ref_out, ref_prof, dtype, label: str) -> float:
    """Hold a kernel result against the plain version; returns the largest
    absolute output difference.

    fp32: the two sum the same products in another order, so the outputs
    agree to 1e-4 of max|out|.  bf16: each side rounds its own fp32
    accumulator once to bf16, so they may differ by one bf16 rounding
    (2^-8 relative, 2^-7 between two neighbours) plus the fp32 difference.
    The profile comes from the fp32 accumulator in both dtypes: 1e-4 of
    max|out|.
    """
    import torch

    o, r = out.float(), ref_out.float()
    scale = float(r.abs().amax())
    err = (o - r).abs()
    if dtype == torch.bfloat16:
        allowed = 2.0 ** -7 * r.abs() + 1e-4 * scale
    else:
        allowed = torch.full_like(r, 1e-4 * scale)
    if not bool(torch.isfinite(o).all()) or bool((err > allowed).any()):
        raise AssertionError(
            f"{label}: output disagrees with the plain version, max err "
            f"{float(err.max())} (max|out| {scale})")
    if (prof is None) != (ref_prof is None):
        raise AssertionError(f"{label}: profile presence differs")
    if prof is not None:
        if prof.shape != ref_prof.shape:
            raise AssertionError(f"{label}: profile shape {tuple(prof.shape)} "
                                 f"!= {tuple(ref_prof.shape)}")
        perr = float((prof - ref_prof).abs().max())
        if perr > 1e-4 * scale:
            raise AssertionError(f"{label}: profile max err {perr} "
                                 f"(max|out| {scale})")
    return float(err.max())


def ssd_bound_ms(shape) -> tuple:
    """Each state word read once and written once (plus the decays), one
    multiply and one add per word and chunk, in fp32."""
    B, NC, H, P, N = shape
    words = B * NC * H * P * N
    t_bytes = 4 * (2 * words + B * NC * H) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * words / PEAK_OPS_PER_S["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def flash_bound_ms(shape, dtype, causal: bool, q_blk: int) -> tuple:
    """q, k, v read once, the output and profile written once; 4 * D FLOP
    per (q, k) pair this call needs: the causal triangle, or all pairs."""
    import torch

    B, H, T, D = shape
    item = torch.empty((), dtype=dtype).element_size()
    pairs = T * (T + 1) // 2 if causal else T * T
    t_bytes = (4 * B * H * T * D * item + 4 * B * H * (T // q_blk)) \
        / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * D * pairs * B * H \
        / PEAK_OPS_PER_S[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def check_ssd(out, ref, label: str) -> float:
    """The kernel's update is the plain version's two correctly rounded
    operations (multiply, then add): equal bit for bit."""
    import torch

    if out.shape != ref.shape or not torch.equal(out, ref):
        raise AssertionError(
            f"{label}: differs from the plain version, max err "
            f"{float((out - ref).abs().max())}")
    return 0.0


def check_flash(out, prof, ref_out, ref_prof, dtype, label: str) -> float:
    """Hold a flash kernel result against the plain version; returns the
    largest absolute output difference.

    fp32: other summation orders and the online rescaling, 2e-5.  bf16:
    both round their fp32 result once, so they may land one bf16 step apart
    (2^-7 relative) plus the fp32 difference.  Profile: max of fp32 dot
    products summed in another order, 1e-5 relative."""
    import torch

    o, r = out.float(), ref_out.float()
    err = (o - r).abs()
    allowed = (2.0 ** -7 * r.abs() + 2e-5 if dtype == torch.bfloat16
               else torch.full_like(r, 2e-5))
    if not bool(torch.isfinite(o).all()) or bool((err > allowed).any()):
        raise AssertionError(f"{label}: output disagrees with the plain "
                             f"version, max err {float(err.max())}")
    if prof.shape != ref_prof.shape:
        raise AssertionError(f"{label}: profile shape {tuple(prof.shape)} "
                             f"!= {tuple(ref_prof.shape)}")
    perr = (prof - ref_prof).abs()
    if bool((perr > 1e-5 + 1e-5 * ref_prof.abs()).any()):
        raise AssertionError(f"{label}: profile max err {float(perr.max())}")
    return float(err.max())


def kernel_phase(device: str = "cuda", size: int = GEMM,
                 ssd_shape=SSD_SHAPE, flash_shape=FLASH_SHAPE) -> dict:
    """Every kernel against its plain version; on the card also timed.
    Returns one JSON entry per kernel name (``launches`` of the ssd and
    flash entries are filled in by phase 6, this slice's main path)."""
    import torch

    from repro_torch.kernels import (
        launch_counts, ops, reset_launch_counts,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain,
    )
    from repro_torch.kernels.profiled_matmul import (
        profiled_matmul_cuda, profiled_matmul_plain,
    )
    from repro_torch.kernels.ssd_scan import (
        ssd_state_passing_cuda, ssd_state_passing_plain,
    )

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    dtypes = (torch.bfloat16, torch.float32)
    inputs = {dt: (randn(size, size, dtype=dt), randn(size, size, dtype=dt))
              for dt in dtypes}
    # a small product whose 64x32 profile tiles cut through the kernel's
    # 128x128 block tiles, with a ragged block edge (320 = 2.5 * 128)
    small = {dt: (randn(320, 192, dtype=dt), randn(192, 160, dtype=dt))
             for dt in dtypes}
    calls = []   # (label, dtype, a, b, kwargs)
    for dt in dtypes:
        a, b = inputs[dt]
        calls += [
            (f"{size}^3 default blocks", dt, a, b, {}),
            (f"{size}^3 profile tile 256x128", dt, a, b,
             dict(block_m=256, block_n=128)),
            (f"{size}^3 profile=False", dt, a, b, dict(profile=False)),
        ]
        a, b = small[dt]
        calls.append(("320x192x160 profile tile 64x32", dt, a, b,
                      dict(block_m=64, block_n=32, block_k=64)))

    # ssd_state_passing: the prefill's chunk states (decays in (0, 1), as
    # exp of a non-positive cumsum), with and without a starting state, and
    # a small shape whose P*N = 35 cuts through the 256-thread CUDA blocks
    def ssd_case(shape, init):
        B, NC, H, P, N = shape
        return (randn(*shape), torch.sigmoid(randn(B, NC, H)),
                randn(B, H, P, N) if init else None)

    ssd_calls = [(f"{list(ssd_shape)}", ssd_case(ssd_shape, False)),
                 (f"{list(ssd_shape)} init_state", ssd_case(ssd_shape, True)),
                 ("[2, 5, 3, 7, 5] init_state", ssd_case((2, 5, 3, 7, 5),
                                                         True))]
    # flash_attention: the shared block's call (q_block = kv_block = 128),
    # and a 256-row profile word over four 64-row CUDA blocks whose logits
    # are all negative (q . k < 0)
    B, H, Tf, D = flash_shape
    fq = {dt: tuple(randn(B, H, Tf, D, dtype=dt) for _ in range(3))
          for dt in dtypes}
    nq, nk, nv = (randn(1, 4, 1024, D) for _ in range(3))
    neg = (-nq.abs(), nk.abs(), nv)
    blk = dict(q_block=128, kv_block=128)
    flash_calls = [
        (f"{list(flash_shape)} bf16 causal", torch.bfloat16,
         fq[torch.bfloat16], dict(causal=True, **blk)),
        (f"{list(flash_shape)} fp32 causal", torch.float32,
         fq[torch.float32], dict(causal=True, **blk)),
        (f"{list(flash_shape)} fp32 non-causal", torch.float32,
         fq[torch.float32], dict(causal=False, **blk)),
        ("[1, 4, 1024, 64] fp32 profile word 256 rows, logits < 0",
         torch.float32, neg, dict(causal=True, q_block=256, kv_block=256)),
    ]

    # the kernel layer's entry points, counts zeroed first
    reset_launch_counts()
    results = [ops.profiled_matmul_op(a, b, **kw) for _, _, a, b, kw in calls]
    ssd_out = [ops.ssd_state_passing_op(s, d, head_block=s.shape[2],
                                        init_state=s0)
               for _, (s, d, s0) in ssd_calls]
    flash_out = [ops.flash_attention_op(*qkv, **kw)
                 for _, _, qkv, kw in flash_calls]
    if device == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    say(f"kernel launches in the kernel phase: {launches}")

    errs = {}
    for (label, dt, a, b, kw), (out, prof) in zip(calls, results):
        ref_out, ref_prof = profiled_matmul_plain(a, b, **kw)
        err = check_gemm(out, prof, ref_out, ref_prof, dt,
                         f"{label} {dt}")
        name = "profiled_matmul_" + ("bf16" if dt == torch.bfloat16
                                     else "f32")
        errs[name] = max(errs.get(name, 0.0), err)
        say(f"  {label:34s} {str(dt):15s} max|err| {err:.6g}  ok")
    errs["ssd_state_passing"] = 0.0
    for (label, (s, d, s0)), out in zip(ssd_calls, ssd_out):
        ref = ssd_state_passing_plain(s, d, head_block=s.shape[2],
                                      init_state=s0)
        check_ssd(out, ref, label)
        say(f"  ssd_state_passing {label:34s} equal bit for bit  ok")
    errs["flash_attention"] = 0.0
    for (label, dt, qkv, kw), (out, prof) in zip(flash_calls, flash_out):
        ref_out, ref_prof = flash_attention_plain(*qkv, **kw)
        err = check_flash(out, prof, ref_out, ref_prof, dt, label)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        say(f"  flash_attention {label:52s} max|err| {err:.6g}, profile "
            f"max {float(prof.max()):.4f}  ok")
    if device != "cuda":
        return {}

    for name in ("profiled_matmul_bf16", "profiled_matmul_f32",
                 "ssd_state_passing", "flash_attention"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched in the kernel "
                                 "phase")
    entries = {}
    for dt in dtypes:
        name = "profiled_matmul_" + ("bf16" if dt == torch.bfloat16
                                     else "f32")
        a, b = inputs[dt]
        tiles = (size // 256) * (size // 256)
        ms = cuda_ms(lambda: profiled_matmul_cuda(a, b), iters=10)
        plain_ms = cuda_ms(lambda: profiled_matmul_plain(a, b), iters=10)

        def library():
            c = torch.matmul(a, b)
            return c.float().abs().reshape(
                size // 256, 256, size // 256, 256).amax(dim=(1, 3))

        library_ms = cuda_ms(library, iters=10)
        bound_ms, bound_by = gemm_bound_ms(size, size, size, dt, tiles)
        say(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul+amax {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); {2 * size ** 3 / ms / 1e9:.2f} TFLOP/s")
        entries[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/profiled_matmul.cu",
            replaces="src/repro/kernels/profiled_matmul.py:23",
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms)

    s, d, _ = ssd_calls[0][1]
    ms = cuda_ms(lambda: ssd_state_passing_cuda(s, d, head_block=s.shape[2]),
                 iters=20)
    plain_ms = cuda_ms(lambda: ssd_state_passing_plain(
        s, d, head_block=s.shape[2]), iters=20)
    bound_ms, bound_by = ssd_bound_ms(ssd_shape)
    say(f"  ssd_state_passing {list(ssd_shape)}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library: none (no single PyTorch call computes "
        f"this scan), bound {bound_ms:.4f} ms ({bound_by}); "
        f"{2 * 4 * s.numel() / ms / 1e6:.1f} GB/s")
    entries["ssd_state_passing"] = dict(
        name="ssd_state_passing", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_state_passing.cu",
        replaces="src/repro/kernels/ssd_scan.py:26", launches=None,
        max_abs_err=errs["ssd_state_passing"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    q, k, v = fq[torch.bfloat16]
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **blk), iters=5)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **blk),
                       iters=5)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=5)
    bound_ms, bound_by = flash_bound_ms(flash_shape, torch.bfloat16, True,
                                        128)
    flop = 4 * D * (Tf * (Tf + 1) // 2) * B * H
    say(f"  flash_attention {list(flash_shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{flop / ms / 1e9:.2f} TFLOP/s")
    entries["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30", launches=None,
        max_abs_err=errs["flash_attention"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return entries


# --------------------------------------------------------------------- #
# phase 4: the paper flow
# --------------------------------------------------------------------- #
def forward_check(graph, device: str) -> int:
    """``forward`` with the profile stream on ``device`` against the CPU,
    then ``ProfileCollector.ingest``; returns the number of signals."""
    import numpy as np
    import torch

    from repro_torch.core import ProfileCollector
    from repro_torch.rinn import forward, init_params

    x = torch.randn(16, generator=torch.Generator().manual_seed(1))
    params = init_params(graph, 0, device=device)
    y, stream = forward(graph, params, x.to(device))
    y_cpu, stream_cpu = forward(graph, init_params(graph, 0, device="cpu"), x)
    if y.shape != y_cpu.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"forward output {tuple(y.shape)} is wrong")
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(),
                               rtol=1e-5, atol=1e-5)
    decoded = ProfileCollector().ingest(stream)
    want = stream_cpu.decode()
    if list(decoded) != list(want) or len(decoded) != stream.n_signals:
        raise AssertionError("decoded profile labels differ from the CPU's")
    for name, vals in want.items():
        np.testing.assert_allclose(decoded[name], vals, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    return len(decoded)


def paper_flow_phase(device: str = "cuda") -> None:
    from repro_torch.rinn import RinnConfig, ZCU102, compare, generate_rinn

    for name, cfg, kw, want in PAPER_FLOW:
        graph = generate_rinn(RinnConfig(**cfg))
        n_sig = forward_check(graph, device)
        reps, secs = {}, {}
        for dev in (device, device, "cpu"):  # the first call warms up
            t0 = time.perf_counter()
            reps[dev] = compare(graph, ZCU102, device=dev, **kw)
            secs[dev] = time.perf_counter() - t0
        rep = reps[device]
        if rep.table() != reps["cpu"].table():
            raise AssertionError(f"{name}: the Table-I report on {device} "
                                 "differs from the CPU's")
        got = dict(
            n_signals=rep.n_signals,
            sum_abs_diff=sum(r.diff for r in rep.rows),
            max_abs_diff=rep.max_abs_diff, min_depth=rep.min_depth,
            max_depth=rep.max_depth,
            cycles_unprofiled=rep.cycles_unprofiled,
            cycles_profiled=rep.cycles_profiled,
            remediation_attempts=len(rep.remediation))
        say(f"  {name}: forward + stream ok ({n_sig} decoded signals); "
            f"compare {got} mean|diff| {rep.mean_abs_diff:.4f}, equal to the "
            f"CPU's; compare takes {secs[device]:.3f} s on {device}, "
            f"{secs['cpu']:.3f} s on the host CPU")
        if got != want:
            raise AssertionError(f"{name}: {got} != JAX reference {want}")


# --------------------------------------------------------------------- #
# phase 5: the fault campaign
# --------------------------------------------------------------------- #
def campaign_phase(device: str = "cuda", lanes: int = CAMPAIGN_LANES) -> float:
    from repro_torch.rinn import (
        FaultPlan, RinnConfig, ZCU102, compile_graph, generate_rinn,
        run_sim, run_sim_batch,
    )

    sim = compile_graph(generate_rinn(RinnConfig(**PAPER_FLOW[0][1])), ZCU102)
    # faults drawn over the run's own length (the profiled run takes 251
    # cycles), so that they land inside it rather than after its end
    horizon = PAPER_FLOW[0][3]["cycles_profiled"]
    plans = [FaultPlan.generate(sim, seed=i, n_stalls=1, n_corruptions=1,
                                horizon=horizon) for i in range(lanes)]
    profiled = [i % 2 == 1 for i in range(lanes)]
    kw = dict(plans=plans, profiled=profiled)
    run_sim_batch(sim, device=device, **kw)  # warm-up
    t0 = time.perf_counter()
    on_device = run_sim_batch(sim, device=device, **kw)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = run_sim_batch(sim, device="cpu", **kw)
    cpu_secs = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(on_device, on_cpu)) if a != b]
    if bad:
        raise AssertionError(f"{len(bad)} lanes differ from the CPU run, "
                             f"first {bad[:8]}")
    clean = {p: run_sim(sim, profiled=p, device="cpu") for p in (False, True)}
    hit = sum(1 for r, p in zip(on_cpu, profiled)
              if (r.cycles, r.fifo_max, r.fifo_profiled)
              != (clean[p].cycles, clean[p].fifo_max, clean[p].fifo_profiled))
    say(f"  {lanes} lanes ({hit} changed by their faults, "
        f"{sum(r.completed for r in on_cpu)} completed), end to end through "
        f"run_sim_batch: {device} {secs:.3f} s = {lanes / secs:.1f} "
        f"lanes/s; host CPU {cpu_secs:.3f} s = {lanes / cpu_secs:.1f} "
        f"lanes/s; every SimResult field equal")
    if device == "cuda":
        # the batch steps its longest lane, checking for the end every
        # CHECK_EVERY cycles
        from repro_torch.rinn.batchsim import CHECK_EVERY
        longest = max(r.cycles for r in on_cpu)
        steps = -(-longest // CHECK_EVERY) * CHECK_EVERY
        simulate_breakdown(sim, plans, profiled, steps)
    return lanes / secs


def simulate_breakdown(sim, plans, profiled, steps: int) -> None:
    """Split one ``run_sim_batch`` of the campaign into its parts: packing
    on the host, ``_simulate`` alone (bracketed by synchronisations), and
    the copy back with ``_unpack``; then the card's busy time during one
    more ``_simulate``, summed over the kernels ``torch.profiler`` saw."""
    import torch

    from repro_torch.rinn import batchsim as bs

    dev = torch.device("cuda")
    bucket = bs.machine_bucket(sim, max(bs._stall_slots(p) for p in plans))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = [bs.pack_faults(sim, bucket, p, None, pr, 200_000)
              for p, pr in zip(plans, profiled)]
    machine = bs._stack([bs.pack_machine(sim, bucket)], dev)
    faults = bs._stack([ops for ops, _, _ in packed], dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = bs._simulate(machine, faults)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [o.cpu().numpy() for o in outs]
    for b, (plan, pr) in enumerate(zip(plans, profiled)):
        bs._unpack(sim, packed[b][1], plan, pr, packed[b][2],
                   [o[b] for o in host])
    unpack_s = time.perf_counter() - t0
    say(f"  parts: pack {pack_s:.4f} s, _simulate {sim_s:.4f} s "
        f"({steps} steps, {sim_s / steps * 1e3:.4f} ms per step), copy "
        f"back + unpack {unpack_s:.4f} s")

    kinds = (torch.profiler.ProfilerActivity.CPU,
             torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=kinds) as trace:
        bs._simulate(machine, faults)
        torch.cuda.synchronize()
    kernels = [e for e in trace.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels:
        say("  card busy time during _simulate: not measured (the profiler "
            "recorded no device events)")
        return
    say(f"  card busy during _simulate (torch.profiler, {len(kernels)} "
        f"device events, {len(kernels) / steps:.1f} per step): "
        f"{busy_ms:.3f} ms of {sim_s * 1e3:.3f} ms unprofiled wall = "
        f"{busy_ms / (sim_s * 1e3):.4f}; {busy_ms / steps * 1e3:.2f} us "
        f"busy per step")


# --------------------------------------------------------------------- #
# phase 6: hybrid serving at full width
# --------------------------------------------------------------------- #
def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def prefill_breakdown(run, top: int = 12) -> None:
    """Device time of one prefill by kernel name (``torch.profiler``), and
    the two ported kernels' share of it."""
    import torch

    kinds = (torch.profiler.ProfilerActivity.CPU,
             torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=kinds) as trace:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in trace.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        say("  prefill breakdown: not measured (the profiler recorded no "
            "device events)")
        return
    busy = sum(ms for ms, _ in by_name.values())
    say(f"  prefill under torch.profiler: {wall_ms:.3f} ms wall, card busy "
        f"{busy:.3f} ms ({busy / wall_ms:.4f}), {sum(n for _, n in by_name.values())} "
        f"device events; top {top} by device time:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        say(f"    {ms:10.3f} ms {ms / busy:7.4f}  x{n:<5d} {name[:90]}")
    for kernel in ("ssd_state_passing_kernel", "flash_fwd_kernel"):
        ms = sum(v[0] for k, v in by_name.items() if kernel in k)
        n = sum(v[1] for k, v in by_name.items() if kernel in k)
        say(f"  {kernel}: {ms:.3f} ms in {n} launches, {ms / busy:.4f} of "
            "the card's busy time")
    # the same device time by the PyTorch op that launched it (the two
    # ported kernels are launched through ctypes, not an op: see above)
    cpu = torch.autograd.DeviceType.CPU
    ops = [(getattr(a, "self_device_time_total", 0.0) / 1e3, a.count, a.key)
           for a in trace.key_averages()
           if getattr(a, "device_type", cpu) == cpu]
    ops = sorted((o for o in ops if o[0] > 0), reverse=True)[:top]
    say(f"  top {top} PyTorch ops by self device time:")
    for ms, n, key in ops:
        say(f"    {ms:10.3f} ms {ms / busy:7.4f}  x{n:<5d} {key[:60]}")


def decode_breakdown(cfg, params, batch: int, device: str = "cuda",
                     steps: int = 3) -> None:
    """Wall time and the card's busy time of one full-width decode step
    (``make_serve_step``, warm), bracketed by synchronisations."""
    import torch

    from repro_torch.models.api import init_caches
    from repro_torch.train.step import make_serve_step

    step = make_serve_step(cfg)
    caches = init_caches(cfg, batch, 64, device=device)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)
    for pos in range(steps):
        tok, caches, _ = step(params, caches, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches, _ = step(params, caches, tok, steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = (torch.profiler.ProfilerActivity.CPU,
             torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=kinds) as trace:
        step(params, caches, tok, steps + 1)
        torch.cuda.synchronize()
    dev = [e for e in trace.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    say(f"  one warm decode step, batch {batch}: {wall_ms:.3f} ms wall; "
        f"under torch.profiler {len(dev)} device events, card busy "
        f"{busy:.3f} ms = {busy / wall_ms:.4f} of the unprofiled wall")


def hybrid_phase(device: str = "cuda") -> dict:
    """Returns the launches of the main path's run, by kernel name."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import count_params, init_params, param_bytes
    from repro_torch.models.api import model_specs, prefill_fn
    from repro_torch.models.hybrid import hybrid_hidden

    cfg = get_config(ARCH)
    specs = model_specs(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, 0, device=device)
    torch.cuda.synchronize()
    say(f"  {ARCH}: {cfg.n_layers} Mamba2 layers, shared block at "
        f"{cfg.n_layers // cfg.shared_attn_every} sites, d_model "
        f"{cfg.d_model}; {count_params(specs)} parameters, "
        f"{param_bytes(specs)} bytes in {cfg.param_dtype}, initialised on "
        f"{device} in {time.perf_counter() - t0:.2f} s")

    B, T = PREFILL
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     generator=gen, device=device)}
    with torch.inference_mode():
        # the main path: counts zeroed just before, read just after
        reset_launch_counts()
        h, caches = prefill_fn(cfg, params, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        say(f"  prefill_fn on [{B}, {T}]: kernel launches {launches}")
        want = {"ssd_state_passing": cfg.n_layers,
                "flash_attention": cfg.n_layers // cfg.shared_attn_every}
        for name, n in want.items():
            if device == "cuda" and launches.get(name, 0) != n:
                raise AssertionError(f"{name}: {launches.get(name, 0)} "
                                     f"launches per prefill, expected {n}")
        if (tuple(h.shape) != (B, 1, cfg.d_model) or caches is not None
                or not bool(torch.isfinite(h).all())):
            raise AssertionError(f"prefill output {tuple(h.shape)} is wrong "
                                 "or not finite")

        times = [cuda_ms(lambda: prefill_fn(cfg, params, batch), iters=1,
                         warmup=1 if i == 0 else 0) for i in range(3)]
        say(f"  three warm prefills (CUDA events): "
            f"{', '.join(f'{t:.3f}' for t in times)} ms; mean "
            f"{sum(times) / 3:.3f} ms = {B * T / (sum(times) / 3) * 1e3:.1f} "
            f"tokens/s")
        prefill_breakdown(lambda: prefill_fn(cfg, params, batch))
        decode_breakdown(cfg, params, SERVE["batch"], device)
    del params, h

    # exactness: full width, depth 6 (one shared site), fp32, card vs host
    n_layers, eb, et = EXACT["n_layers"], EXACT["batch"], EXACT["seq"]
    cfg6 = dataclasses.replace(cfg, n_layers=n_layers,
                               param_dtype="float32",
                               activation_dtype="float32")
    p6 = init_params(model_specs(cfg6), 0, device=device)
    p6_cpu = _tree_to(p6, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (eb, et),
                         generator=torch.Generator().manual_seed(2))
    pos = torch.arange(et)[None].expand(eb, et)
    with torch.inference_mode():
        t0 = time.perf_counter()
        h_card, rows_card, _ = hybrid_hidden(cfg6, p6, toks.to(device),
                                             pos.to(device))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_cpu, rows_cpu, _ = hybrid_hidden(cfg6, p6_cpu, toks, pos)
        cpu_s = time.perf_counter() - t0
    err = float((h_card.cpu() - h_cpu).abs().max())
    rerr = float(((rows_card.cpu() - rows_cpu).abs()
                  / rows_cpu.abs().clamp(min=1.0)).max())
    say(f"  exactness, full width, depth {n_layers}, [{eb}, {et}], fp32 (TF32 "
        f"off): max |h_card - h_cpu| {err:.3g} (max |h| "
        f"{float(h_cpu.abs().max()):.4g}), profile rows max rel err "
        f"{rerr:.3g}; card {card_s:.3f} s (first call), host CPU "
        f"{cpu_s:.3f} s")
    # tolerance: fp32 sums over K = 2048..8192 in other orders (cuBLAS vs
    # the CPU's BLAS) through 6 layers and one attention site
    if not (err <= 1e-4 * max(1.0, float(h_cpu.abs().max())) and rerr <= 1e-4):
        raise AssertionError(f"card and CPU prefill differ: {err}, {rerr}")
    del p6, p6_cpu

    # the serving entry point at full width
    for corrupt in (0, 1):
        res = run_serve(ARCH, reduced=False, device=device,
                        corrupt_every=corrupt, **SERVE)
        tokens = res.tokens
        shape = (SERVE["batch"], SERVE["prompt_len"] + SERVE["gen"])
        if (tuple(tokens.shape) != shape or int(tokens.min()) < 0
                or int(tokens.max()) >= cfg.vocab_size):
            raise AssertionError(f"run_serve tokens {tuple(tokens.shape)} "
                                 f"!= {shape} or out of the vocabulary")
        ladder = [e.to_policy for e in res.supervisor.events]
        if ladder != (["shortcut", "off"] if corrupt else []):
            raise AssertionError(f"corrupt_every={corrupt}: ladder {ladder}")
        say(f"  run_serve(reduced=False, corrupt_every={corrupt}): tokens "
            f"{tuple(tokens.shape)}, {res.toks_per_s:.1f} tok/s (host clock, "
            f"whole loop); {res.supervisor.summary()}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("set torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.backends.cudnn.allow_tf32 = False")
    card = card_line()
    say(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build_all(build.KERNELS)
    say(f"[2] built {', '.join(build.KERNELS)} with nvcc for sm_90a, in "
        f"parallel, in {time.perf_counter() - t0:.2f} s into "
        f"{build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"    {name}: {line.strip()}")

    say(f"[3] kernel layer: profiled_matmul_op at {GEMM}^3, "
        f"ssd_state_passing_op at {list(SSD_SHAPE)}, flash_attention_op at "
        f"{list(FLASH_SHAPE)}")
    entries = kernel_phase("cuda", GEMM)
    say("[4] paper flow on cuda")
    paper_flow_phase("cuda")
    say(f"[5] fault campaign: {CAMPAIGN_LANES} lanes of the Table-I machine")
    campaign_phase("cuda", CAMPAIGN_LANES)
    say(f"[6] hybrid serving at full width: {ARCH}")
    launches = hybrid_phase("cuda")
    for name in ("ssd_state_passing", "flash_attention"):
        entries[name]["launches"] = launches[name]

    say(json.dumps({"kernels": list(entries.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
