"""Parity of the PyTorch port's cycle simulator with the JAX package.

Integer outputs must be equal exactly: the compiled machine, the seeded
fault plans, and every ``SimResult`` field over the fig5 connection
patterns x 3 seeds x ``FaultPlan.generate`` plans (stalls, drops, dups,
capacity faults, profile-word corruptions) x profiled on/off.  The port's
batched and multi-machine runs must equal its sequential runs.
"""
import dataclasses

import numpy as np
import pytest
from _hypothesis_shim import given, settings, st

import repro.rinn as J
import repro_torch.rinn as T
from repro_torch.rinn import batchsim as tb

CPU = dict(device="cpu")


def cfg(pattern="long_skip", seed=1, **kw):
    base = dict(family="conv", n_backbone=5, image_size=5, filters=2,
                kernel=3, pattern=pattern, density=0.3, seed=seed)
    base.update(kw)
    return base


def both_sims(timing=None, **c):
    jsim = J.compile_graph(J.generate_rinn(J.RinnConfig(**c)),
                           timing or J.ZCU102)
    tsim = T.compile_graph(T.generate_rinn(T.RinnConfig(**c)),
                           T.ZCU102 if timing is None else
                           T.TimingProfile(**dataclasses.asdict(timing)))
    return jsim, tsim


def as_dict(result):
    return dataclasses.asdict(result)


def assert_compiled_equal(jsim, tsim):
    for f in dataclasses.fields(jsim):
        a, b = getattr(jsim, f.name), getattr(tsim, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def fault_plans(gen, sim, seed, horizon):
    """Seeded plans of every fault kind, drawn by ``gen`` (either
    package's ``FaultPlan.generate``), plus a capacity fault."""
    plans = [
        None,
        gen(sim, seed=seed, n_stalls=1, n_corruptions=1, horizon=horizon),
        gen(sim, seed=seed + 100, n_stalls=2, n_dups=1, n_corruptions=2,
            horizon=horizon, bias="critical_path"),
        gen(sim, seed=seed + 200, n_stalls=1, n_drops=1, n_corruptions=1,
            horizon=horizon),
    ]
    return plans


# --------------------------------------------------------------------- #
# SimResult parity over patterns x seeds x plans x profiled
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pattern", list(J.PATTERNS))
def test_sim_results_equal_reference(pattern):
    for seed in range(3):
        jsim, tsim = both_sims(**cfg(pattern, seed))
        assert_compiled_equal(jsim, tsim)
        jplans = fault_plans(J.FaultPlan.generate, jsim, seed, 120)
        tplans = fault_plans(T.FaultPlan.generate, tsim, seed, 120)
        # a capacity fault on the first edge, too small to complete
        jplans.append(J.FaultPlan(capacities=(
            J.CapacityFault(edge=jsim.edge_list[0], capacity=1),)))
        tplans.append(T.FaultPlan(capacities=(
            T.CapacityFault(edge=tsim.edge_list[0], capacity=1),)))
        assert [as_dict(p) if p else None for p in tplans] == [
            as_dict(p) if p else None for p in jplans]

        lanes = [(i, prof) for i in range(len(jplans)) for prof in (False,
                                                                  True)]
        kw = dict(profiled=[p for _, p in lanes], max_cycles=5_000)
        want = J.run_sim_batch(jsim, plans=[jplans[i] for i, _ in lanes],
                               **kw)
        got = T.run_sim_batch(tsim, plans=[tplans[i] for i, _ in lanes],
                              **kw, **CPU)
        assert [as_dict(r) for r in got] == [as_dict(r) for r in want]
        if seed == 0:  # sequential runs of the port equal its batch
            for (i, prof), r in zip(lanes, got):
                seq = T.run_sim(tsim, profiled=prof, max_cycles=5_000,
                                faults=tplans[i], **CPU)
                assert as_dict(seq) == as_dict(r)


def test_fault_plans_equal_reference():
    jsim, tsim = both_sims(**cfg("density", 3))
    for seed in range(20):
        for bias in ("uniform", "critical_path"):
            kw = dict(seed=seed, n_stalls=3, n_drops=2, n_dups=2,
                      n_corruptions=3, horizon=300, bias=bias)
            assert (as_dict(T.FaultPlan.generate(tsim, **kw))
                    == as_dict(J.FaultPlan.generate(jsim, **kw)))
    assert (T.critical_path_actors(tsim) == J.critical_path_actors(jsim))
    assert (T.critical_path_edges(tsim, tsim.edge_list)
            == J.critical_path_edges(jsim, jsim.edge_list))
    with pytest.raises(ValueError):
        T.FaultPlan.generate(tsim, seed=0, bias="chaotic")


@pytest.mark.parametrize("board", ["zcu102", "pynq_z2"])
def test_compiled_machine_and_buckets_equal_reference(board):
    timing = J.BOARDS[board].with_(reuse_factor=4, bitwidth=24,
                                   bitwidth_ii_bump_threshold=16)
    for c in (cfg("density", 0, merge_op="mixed"),
              cfg("ends_only", 4, family="dense", density=0.6)):
        jsim, tsim = both_sims(timing=timing, **c)
        assert_compiled_equal(jsim, tsim)
        for slots in (1, 3, 9):
            assert (dataclasses.asdict(T.machine_bucket(tsim, slots))
                    == dataclasses.asdict(J.machine_bucket(jsim, slots)))
        want = J.run_sim_batch(jsim, n=2, profiled=[False, True])
        got = T.run_sim_batch(tsim, n=2, profiled=[False, True], **CPU)
        assert [as_dict(r) for r in got] == [as_dict(r) for r in want]


def test_capacity_overrides_and_max_cycles_lanes():
    """Lanes that end at different cycles and for different reasons (done,
    deadlock, max_cycles) stay frozen once finished."""
    jsim, tsim = both_sims(timing=J.ZCU102.with_(fifo_capacity=4),
                           **cfg("long_skip", 1))
    grow = {e: 64 for e in jsim.edge_list}
    kw = dict(capacity_overrides=[None, grow, grow, None],
              max_cycles=[20_000, 20_000, 37, 5],
              profiled=[False, True, True, False])
    want = J.run_sim_batch(jsim, **kw)
    got = T.run_sim_batch(tsim, **kw, **CPU)
    assert [as_dict(r) for r in got] == [as_dict(r) for r in want]
    assert [r.completed for r in got] == [False, True, False, False]
    assert got[0].deadlocked and not got[2].deadlocked


def test_run_sim_many_matches_reference_and_singles():
    pairs = [both_sims(**cfg("long_skip", 7, n_backbone=n))
             for n in (4, 5, 6, 6)]
    jsims, tsims = zip(*pairs)
    plans_j = [None, J.FaultPlan.generate(jsims[1], seed=1, horizon=80),
               None, J.FaultPlan.generate(jsims[3], seed=2, horizon=80)]
    plans_t = [None, T.FaultPlan.generate(tsims[1], seed=1, horizon=80),
               None, T.FaultPlan.generate(tsims[3], seed=2, horizon=80)]
    kw = dict(profiled=[True, False, True, True])
    want = J.run_sim_many(list(jsims), plans=plans_j, **kw)
    got = T.run_sim_many(list(tsims), plans=plans_t, **kw, **CPU)
    assert [as_dict(r) for r in got] == [as_dict(r) for r in want]
    for s, p, prof, r in zip(tsims, plans_t, kw["profiled"], got):
        assert as_dict(T.run_sim(s, profiled=prof, faults=p, **CPU)) == (
            as_dict(r))


def test_pack_machine_and_faults_equal_reference():
    jsim, tsim = both_sims(**cfg("short_skip", 2))
    jplan = J.FaultPlan.generate(jsim, seed=4, n_stalls=5, n_drops=1,
                                 n_dups=1, n_corruptions=2, horizon=90)
    tplan = T.FaultPlan.generate(tsim, seed=4, n_stalls=5, n_drops=1,
                                 n_dups=1, n_corruptions=2, horizon=90)
    bucket = J.machine_bucket(jsim, 4)
    tbucket = T.machine_bucket(tsim, 4)
    over = {jsim.edge_list[1]: 7}
    jm = J.batchsim.pack_machine(jsim, bucket)
    tm = tb.pack_machine(tsim, tbucket)
    jf, jcap, jidle = J.batchsim.pack_faults(jsim, bucket, jplan, over, True,
                                             999)
    tf, tcap, tidle = tb.pack_faults(tsim, tbucket, tplan, over, True, 999)
    for a, b in list(zip(jm, tm)) + list(zip(jf, tf)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(jcap, tcap) and jidle == tidle


def test_compile_stats_api():
    _, tsim = both_sims(**cfg("density", 0))
    tb.reset_compile_stats()
    T.run_sim_batch(tsim, n=3, **CPU)
    T.run_sim(tsim, **CPU)
    assert T.compile_stats() == {"traces": 0, "launches": 2, "lanes": 4}
    tb.reset_compile_stats()
    assert T.compile_stats() == {"traces": 0, "launches": 0, "lanes": 0}


def test_batch_rejects_mismatched_lane_counts():
    _, tsim = both_sims(**cfg("density", 0))
    with pytest.raises(ValueError):
        T.run_sim_batch(tsim, plans=[None, None], profiled=[True], **CPU)


@settings(deadline=None, max_examples=4)
@given(st.integers(min_value=0, max_value=50),
       st.sampled_from(list(J.PATTERNS)),
       st.integers(min_value=2, max_value=6))
def test_property_single_runs_equal_reference(seed, pattern, capacity):
    jsim, tsim = both_sims(timing=J.ZCU102.with_(fifo_capacity=capacity),
                           **cfg(pattern, seed, n_backbone=5, image_size=4))
    jplan = J.FaultPlan.generate(jsim, seed=seed, n_stalls=1, n_dups=1,
                                 horizon=60)
    tplan = T.FaultPlan.generate(tsim, seed=seed, n_stalls=1, n_dups=1,
                                 horizon=60)
    for prof in (False, True):
        want = J.run_sim(jsim, profiled=prof, faults=jplan,
                         max_cycles=3_000)
        got = T.run_sim(tsim, profiled=prof, faults=tplan,
                        max_cycles=3_000, **CPU)
        assert as_dict(got) == as_dict(want)
