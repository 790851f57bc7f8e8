"""Serving driver: batched greedy decode with KV-cache occupancy profiling
(port of :mod:`repro.launch.serve`).

Greedy-decodes a batch of prompts with the family's cache machinery; the
SPRING stream reports per-step cache occupancy.  The profiling path runs
under a ``ProfilingSupervisor``: a watchdog and integrity verification
degrade it gracefully (inline → shortcut → off) on repeated faults while
the token path keeps serving.  Ported families: hybrid (zamba2).  CPU
example:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --device cpu --batch 4 --prompt-len 16 --gen 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..core import ProfileCollector, ProfileStream, metrics as M
from ..device import resolve_device
from ..distributed.fault import (
    ProfilingSupervisor, RetryPolicy, Watchdog, retry_with_backoff,
)
from ..models import init_params
from ..models.api import init_caches, model_specs
from ..train.step import make_serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor
    collector: ProfileCollector
    supervisor: ProfilingSupervisor
    watchdog: Watchdog
    toks_per_s: float


def _profile_step(policy: str, pos: int, max_len: int,
                  device) -> ProfileStream:
    """Build this step's profile stream at the supervisor's fidelity rung.

    ``inline`` guards every signal record individually (the faithful
    mechanism); ``shortcut`` emits one fixed-width guarded record (the
    tape-style O(L) path — cheaper, coarser framing).
    """
    occ = M.kv_occupancy(torch.full((1,), pos + 1, device=device), max_len)
    s = ProfileStream.create(device=device)
    if policy == "inline":
        s = s.append_guarded("kv/occupancy", "fifo_fullness", occ)
        s = s.append_guarded("kv/position", "position",
                             torch.full((1,), float(pos + 1), device=device))
    else:  # shortcut: one guarded record row
        row = torch.cat([torch.atleast_1d(occ),
                         torch.full((1,), float(pos + 1), device=device)])
        s = s.append_guarded("kv/record", "record_row", row)
    return s


def run_serve(
    arch: str = "qwen2.5-14b", *, reduced: bool = True, batch: int = 4,
    prompt_len: int = 16, gen: int = 16, seed: int = 0,
    profile_policy: str = "inline", failure_threshold: int = 2,
    overhead_budget: float = 0.25, step_budget_s: float = 5.0,
    corrupt_every: int = 0, trace: bool = False, device=None, params=None,
    prompts: Optional[torch.Tensor] = None,
) -> ServeResult:
    """Decode ``gen`` tokens per sequence under profiling supervision.

    ``corrupt_every > 0`` injects a bit flip into every N-th step's profile
    stream (fault-injection hook): the verified decode quarantines the
    damaged record, the supervisor counts the strike, and after
    ``failure_threshold`` consecutive strikes profiling steps down a rung —
    tokens keep flowing throughout.

    The port's additions: ``device`` (the card by default), and
    ``params`` / ``prompts`` (``[batch, prompt_len]`` token ids) to serve
    given weights and prompts; given weights set the config's parameter
    and activation dtype.  By default both are drawn on ``device`` from
    generators seeded with ``seed`` and ``seed + 1``.
    """
    if trace:
        raise NotImplementedError(
            "trace=True needs the trace/ slice of repro_torch, which is not "
            "ported yet")
    dev = resolve_device(device,
                         like=prompts if prompts is not None else None)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if params is not None:
        dtype = str(params["embed"].dtype).split(".")[-1]
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  activation_dtype=dtype)

    specs = model_specs(cfg)
    if params is None:
        params = init_params(specs, seed, device=dev)
    max_len = prompt_len + gen
    caches = init_caches(cfg, batch, max_len, device=dev)
    if prompts is None:
        gen_p = torch.Generator(device=dev).manual_seed(seed + 1)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gen_p, device=dev)
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts must be {(batch, prompt_len)}, got "
                         f"{tuple(prompts.shape)}")
    prompts = prompts.to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    serve_step = make_serve_step(cfg)
    collector = ProfileCollector()
    supervisor = ProfilingSupervisor(
        policy=profile_policy, failure_threshold=failure_threshold,
        overhead_budget=overhead_budget)
    watchdog = Watchdog(budget_s=step_budget_s)
    retry = RetryPolicy(retries=2, base_delay=0.01)

    # prefill by streaming prompt tokens through the decode path (family-
    # uniform; the hybrid's decode applies its shared sites after the
    # Mamba stack, as the reference's does)
    t0 = time.time()
    with torch.inference_mode():
        for pos in range(prompt_len - 1):
            _, caches, _ = retry_with_backoff(
                serve_step, params, caches, prompts[:, pos:pos + 1], pos,
                policy=retry)
        generated = [prompts]
        tok = prompts[:, -1:]
        for step_i, pos in enumerate(range(prompt_len - 1, max_len - 1)):
            t_step = time.time()
            tok, caches, _ = retry_with_backoff(
                serve_step, params, caches, tok, pos, policy=retry)
            sync()  # the step's latency, not its enqueue time
            generated.append(tok)  # the data path delivers regardless of faults
            if not supervisor.active:
                continue
            t_prof = time.time()
            s = _profile_step(supervisor.policy, pos, max_len, dev)
            if corrupt_every and step_i % corrupt_every == 0:
                s = s.with_bitflip(0)  # in-band fault: payload word bit flip
            _, report = collector.ingest_verified(s)
            if not report.ok:
                supervisor.record_integrity_failure(report.summary())
                continue
            dt_step = time.time() - t_step
            if watchdog.observe(dt_step):
                supervisor.record_overhead(
                    (time.time() - t_prof) / max(dt_step, 1e-9))
            else:
                supervisor.step_ok()
        out = torch.cat(generated, dim=1)
        sync()
    dt = time.time() - t0
    return ServeResult(
        tokens=out, collector=collector, supervisor=supervisor,
        watchdog=watchdog, toks_per_s=batch * (max_len - 1) / dt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-14b")
    # as in the reference, --reduced is on by default and cannot be turned
    # off here; call run_serve(reduced=False) for the full width
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-policy", choices=("inline", "shortcut", "off"),
                    default="inline")
    ap.add_argument("--corrupt-every", type=int, default=0,
                    help="fault injection: flip a bit in every N-th step's "
                         "profile stream")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    res = run_serve(
        args.arch, reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
        profile_policy=args.profile_policy,
        corrupt_every=args.corrupt_every, device=args.device)
    out = res.tokens
    print(f"decoded {tuple(out.shape)} ({res.toks_per_s:.1f} tok/s host)")
    print(res.supervisor.summary())
    print(res.collector.report())
    return out


if __name__ == "__main__":
    main()
