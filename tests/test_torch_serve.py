"""Parity of the PyTorch port's serving path with the JAX package, on the
CPU: ``launch/serve.py::run_serve`` at ``zamba2-1.2b.reduced()``, and the
serving part of ``distributed/fault.py``.

Greedy tokens are compared exactly: in fp32 the two packages' logits agree
to about 1e-6, far inside the gaps between the top two logits of these
runs.  The supervisor's degradation events are compared field by field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import fault as jfault
from repro.launch.serve import run_serve as j_run_serve
from repro.models.api import (
    init_caches as j_init_caches, model_specs as j_model_specs,
)
from repro.models.params import init_params as j_init_params
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.distributed import fault
from repro_torch.launch import serve
from repro_torch.launch.serve import run_serve
from repro_torch.models import params_from_numpy

ARCH = "zamba2-1.2b"
BATCH, PROMPT, GEN = 2, 4, 6


def jax_greedy_tokens(cfg, params, prompts):
    """The reference's serving loop (launch/serve.py) without supervision:
    prompt tokens streamed through make_serve_step, then greedy steps."""
    step = jax.jit(j_make_serve_step(cfg))
    max_len = PROMPT + GEN
    caches = j_init_caches(cfg, BATCH, max_len)
    for pos in range(PROMPT - 1):
        _, caches, _ = step(params, caches, prompts[:, pos:pos + 1], pos)
    out, tok = [prompts], prompts[:, -1:]
    for pos in range(PROMPT - 1, max_len - 1):
        tok, caches, _ = step(params, caches, tok, pos)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_run_serve_tokens_equal_jax_loop():
    cfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                              param_dtype="float32",
                              activation_dtype="float32")
    jp = j_init_params(j_model_specs(cfg), jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (BATCH, PROMPT), 0,
                                 cfg.vocab_size, jnp.int32)
    want = jax_greedy_tokens(cfg, jp, prompts)
    res = run_serve(
        ARCH, reduced=True, batch=BATCH, prompt_len=PROMPT, gen=GEN,
        device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu"),
        prompts=torch.from_numpy(np.array(prompts)).long())
    assert res.tokens.shape == (BATCH, PROMPT + GEN)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.supervisor.policy == "inline" and res.supervisor.events == []
    assert res.collector.integrity_failures == 0
    assert res.toks_per_s > 0


def _events(sup):
    return [(e.step, e.from_policy, e.to_policy, e.reason)
            for e in sup.events]


def test_corrupted_serve_walks_the_same_ladder_as_jax():
    kw = dict(reduced=True, batch=BATCH, prompt_len=PROMPT, gen=GEN,
              corrupt_every=1, failure_threshold=2)
    want = j_run_serve(ARCH, **kw)
    got = run_serve(ARCH, device="cpu", **kw)
    assert got.tokens.shape == tuple(want.tokens.shape) == (BATCH, 10)
    assert _events(got.supervisor) == _events(want.supervisor)
    assert [e[2] for e in _events(got.supervisor)] == ["shortcut", "off"]
    assert got.supervisor.summary() == want.supervisor.summary()
    assert (got.collector.integrity_failures
            == want.collector.integrity_failures >= 2)
    assert got.collector.quarantine_counts == want.collector.quarantine_counts


def test_serve_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="trace/"):
        run_serve(ARCH, device="cpu", trace=True)
    with pytest.raises(NotImplementedError, match="slice"):
        run_serve("qwen2.5-14b", device="cpu", batch=1, prompt_len=2, gen=1)


def test_serve_cli_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "3", "--gen", "2"])
    assert tuple(out.shape) == (2, 5)
    text = capsys.readouterr().out
    assert "decoded (2, 5)" in text and "no degradations" in text


def _drive(mod):
    """One script of supervisor, watchdog and retry calls on a package."""
    sup = mod.ProfilingSupervisor(failure_threshold=2, overhead_budget=0.2)
    sup.record_overhead(0.1)
    sup.record_overhead(0.5)
    sup.step_ok()
    sup.record_integrity_failure("a")
    sup.record_overhead(0.9)
    hb = mod.Heartbeats(3, window=4)
    for lat in ((1.0, 1.0, 5.0), (1.0, 1.1, 6.0), (1.0, 0.9, 7.0)):
        for h, v in enumerate(lat):
            hb.record(h, v)
        sup.observe_heartbeats(hb)
    dog = mod.Watchdog(budget_s=1.0)
    breaches = [dog.observe(x) for x in (0.5, 2.0, 3.0, 0.1)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return len(calls)

    got = mod.retry_with_backoff(flaky, policy=mod.RetryPolicy(retries=3),
                                 sleep=lambda s: None)
    return (_events(sup), sup.policy, sup.summary(), breaches,
            dog.total_breaches, got, mod.PROFILING_LADDER)


def test_fault_serving_part_matches_jax():
    assert _drive(fault) == _drive(jfault)
    with pytest.raises(ValueError):
        fault.ProfilingSupervisor(policy="sometimes")
