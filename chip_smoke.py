#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA.  It imports nothing of JAX
or of the JAX package.  Phases, each of which raises on failure:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the port from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` for ``sm_90a`` (into ``build/kernels/``), timed;
3. kernel layer: ``profiled_matmul_op`` at M = N = K = 4096 in bf16 and fp32
   with the default 256/256/512 blocks, a profile tile (256x128) that spans
   several CUDA blocks, a small shape whose profile tiles cut through the
   CUDA blocks, and ``profile=False``.  Launch counts are zeroed just before
   these calls and read just after; every output and profile is then held
   against the plain PyTorch version on the same inputs, and the kernel, the
   plain version and ``torch.matmul`` (the library yardstick, which the port
   never calls) are timed with CUDA events;
4. paper flow on the card: ``generate_rinn`` -> ``init_params``/``forward``
   with the in-band profile stream -> ``ProfileCollector.ingest`` ->
   ``compare(graph, ZCU102)`` for the Table-I design and the end-to-end test
   design.  The Table-I integers must equal the JAX reference's, and the
   forward output and every decoded profile label must equal a CPU run;
5. fault campaign: 1024 seeded fault-plan lanes of the Table-I machine in
   one ``run_sim_batch`` on the card, every ``SimResult`` field equal to the
   port's CPU run of the same lanes; then the same batch in parts (host
   packing, ``_simulate`` alone, copy back and unpacking) and the card's
   busy time during ``_simulate`` from ``torch.profiler``.

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


def kernel_phase(device: str = "cuda", size: int = GEMM) -> list:
    import torch

    from repro_torch.kernels import (
        launch_counts, ops, reset_launch_counts,
    )
    from repro_torch.kernels.profiled_matmul import (
        profiled_matmul_cuda, profiled_matmul_plain,
    )

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype):
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

    # the main path: the kernel layer's public entry, counts zeroed first
    reset_launch_counts()
    results = [ops.profiled_matmul_op(a, b, **kw) for _, _, a, b, kw in calls]
    if device == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    say(f"kernel launches on the main path: {launches}")

    errs = {}
    for (label, dt, a, b, kw), (out, prof) in zip(calls, results):
        ref_out, ref_prof = profiled_matmul_plain(a, b, **kw)
        err = check_gemm(out, prof, ref_out, ref_prof, dt,
                         f"{label} {dt}")
        name = "profiled_matmul_" + ("bf16" if dt == torch.bfloat16
                                     else "f32")
        errs[name] = max(errs.get(name, 0.0), err)
        say(f"  {label:34s} {str(dt):15s} max|err| {err:.6g}  ok")
    if device != "cuda":
        return []

    entries = []
    for dt in dtypes:
        name = "profiled_matmul_" + ("bf16" if dt == torch.bfloat16
                                     else "f32")
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched on the main path")
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
        entries.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/profiled_matmul.cu",
            replaces="src/repro/kernels/profiled_matmul.py:23",
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
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

    from repro_torch.kernels.profiled_matmul import KERNEL

    t0 = time.perf_counter()
    log = build.build(KERNEL)
    say(f"[2] built {KERNEL} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"    {line.strip()}")

    say(f"[3] kernel layer: profiled_matmul_op at {GEMM}^3")
    entries = kernel_phase("cuda", GEMM)
    say("[4] paper flow on cuda")
    paper_flow_phase("cuda")
    say(f"[5] fault campaign: {CAMPAIGN_LANES} lanes of the Table-I machine")
    campaign_phase("cuda", CAMPAIGN_LANES)

    say(json.dumps({"kernels": entries}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
