"""Parity of the PyTorch port's cosim harness with the JAX package.

``CosimReport.table()``, the remediation log and ``remediated_capacities``,
``DeadlockReport`` (for the deadlock repro: a long-skip graph at FIFO
capacity 2), the speculative and serial remediation ladders, and
``cosim_many`` must be equal exactly.  The options that need slices not yet
ported raise ``NotImplementedError``.
"""
import dataclasses

import pytest

import repro.rinn as J
import repro_torch.rinn as T
from repro_torch.core import ProfileCollector

CPU = dict(device="cpu")


def graphs(**kw):
    return J.generate_rinn(J.RinnConfig(**kw)), T.generate_rinn(
        T.RinnConfig(**kw))


def timings(**kw):
    return J.ZCU102.with_(**kw), T.ZCU102.with_(**kw)


def deadlock_repro():
    """The fast deadlock repro: a long-skip graph whose FIFOs hold 2 words."""
    return graphs(family="conv", n_backbone=6, image_size=6, filters=2,
                  kernel=3, pattern="long_skip", density=0.3, seed=1)


def as_dict(x):
    return dataclasses.asdict(x)


def assert_reports_equal(got, want):
    assert got.table() == want.table()
    assert [as_dict(r) for r in got.rows] == [as_dict(r) for r in want.rows]
    assert (got.cycles_unprofiled, got.cycles_profiled, got.completed) == (
        want.cycles_unprofiled, want.cycles_profiled, want.completed)
    assert (got.mean_abs_diff, got.max_abs_diff, got.min_depth,
            got.max_depth) == (want.mean_abs_diff, want.max_abs_diff,
                               want.min_depth, want.max_depth)
    assert got.remediated_capacities == want.remediated_capacities
    assert [as_dict(a) for a in got.remediation] == [
        as_dict(a) for a in want.remediation]
    assert ({t: [as_dict(r) for r in rows]
             for t, rows in got.by_layer_type().items()}
            == {t: [as_dict(r) for r in rows]
                for t, rows in want.by_layer_type().items()})


@pytest.mark.parametrize("kw,capacity,auto", [
    (dict(family="conv", n_backbone=8, image_size=8, filters=2, kernel=3,
          pattern="density", density=0.35, merge_op="add", seed=42),
     None, True),
    (dict(n_backbone=5, image_size=6, seed=2, pattern="long_skip",
          density=0.5), None, False),
    (dict(family="conv", n_backbone=6, image_size=6, filters=2, kernel=3,
          pattern="long_skip", density=0.3, seed=1), 4, True),
    (dict(family="dense", n_backbone=6, density=0.5, merge_op="concat",
          seed=3), None, False),
])
def test_compare_table_equals_reference(kw, capacity, auto):
    jg, tg = graphs(**kw)
    jt, tt = timings(**({} if capacity is None else
                        dict(fifo_capacity=capacity)))
    want = J.compare(jg, jt, max_cycles=20_000, auto_remediate=auto)
    got = T.compare(tg, tt, max_cycles=20_000, auto_remediate=auto, **CPU)
    assert_reports_equal(got, want)
    if capacity is not None:
        assert got.remediation and got.remediated_capacities


def test_deadlock_report_equals_reference():
    jg, tg = deadlock_repro()
    jt, tt = timings(fifo_capacity=2)
    with pytest.raises(J.DeadlockError) as jerr:
        J.cosim_only(jg, jt)
    with pytest.raises(T.DeadlockError) as terr:
        T.cosim_only(tg, tt, **CPU)
    want, got = jerr.value.report, terr.value.report
    assert as_dict(got) == as_dict(want)
    assert got.summary() == want.summary() == str(terr.value)
    assert got.capacity_induced and got.blocked_edge_set == (
        want.blocked_edge_set)
    assert got.suggested_capacities(3) == want.suggested_capacities(3)
    assert ([b.reason for b in got.blocked]
            == [b.reason for b in want.blocked])
    # auto_remediate sizes the deadlock away, to the same result
    want_res = J.cosim_only(jg, jt, auto_remediate=True)
    got_res = T.cosim_only(tg, tt, auto_remediate=True, **CPU)
    assert got_res.completed and as_dict(got_res) == as_dict(want_res)


@pytest.mark.parametrize("speculative", [True, False])
def test_run_with_remediation_equals_reference(speculative):
    jg, tg = deadlock_repro()
    jt, tt = timings(fifo_capacity=2)
    jsim, tsim = J.compile_graph(jg, jt), T.compile_graph(tg, tt)
    seed_map = {jsim.edge_list[0]: 3}
    for kw in (dict(profiled=True), dict(initial_overrides=seed_map),
               dict(budget=2, growth=3)):
        want_res, want_log = J.run_with_remediation(
            jsim, speculative=speculative, **kw)
        got_res, got_log = T.run_with_remediation(
            tsim, speculative=speculative, **kw, **CPU)
        assert as_dict(got_res) == as_dict(want_res)
        assert [as_dict(a) for a in got_log] == [as_dict(a) for a in want_log]


def test_remediation_gives_up_on_starvation_like_reference():
    jg, tg = deadlock_repro()
    jsim, tsim = J.compile_graph(jg, J.ZCU102), T.compile_graph(tg, T.ZCU102)
    e = jsim.edge_list[2]
    jplan = J.FaultPlan(drops=(J.BeatFault(edge=e, beat=3),))
    tplan = T.FaultPlan(drops=(T.BeatFault(edge=e, beat=3),))
    want = J.run_with_remediation(jsim, faults=jplan)
    got = T.run_with_remediation(tsim, faults=tplan, **CPU)
    assert as_dict(got[0]) == as_dict(want[0])
    assert [as_dict(a) for a in got[1]] == [as_dict(a) for a in want[1]]
    assert not got[1][-1].report.capacity_induced
    # diagnose on the stalled result
    assert as_dict(T.diagnose(tsim, got[0])) == as_dict(
        J.diagnose(jsim, want[0]))


def test_remediate_pair_equals_reference():
    jg, tg = deadlock_repro()
    jt, tt = timings(fifo_capacity=3)
    jsim, tsim = J.compile_graph(jg, jt), T.compile_graph(tg, tt)
    want = J.remediate_pair(jsim, max_cycles=20_000)
    got = T.remediate_pair(tsim, max_cycles=20_000, **CPU)
    assert as_dict(got[0]) == as_dict(want[0])
    assert as_dict(got[1]) == as_dict(want[1])
    assert [as_dict(a) for a in got[2]] == [as_dict(a) for a in want[2]]
    assert got[3] == want[3]


def test_cosim_many_equals_reference():
    pairs = [graphs(family="conv", n_backbone=6, image_size=6, filters=2,
                    kernel=3, pattern="long_skip", density=0.3, seed=s)
             for s in (1, 2, 3)]
    jgs, tgs = zip(*pairs)
    for cap in (4, None):
        jt, tt = timings(**({} if cap is None else dict(fifo_capacity=cap)))
        want = J.cosim_many(list(jgs), jt, max_cycles=20_000, profiled=True)
        got = T.cosim_many(list(tgs), tt, max_cycles=20_000, profiled=True,
                           **CPU)
        assert [(as_dict(r), rep and as_dict(rep)) for r, rep in got] == [
            (as_dict(r), rep and as_dict(rep)) for r, rep in want]


@pytest.mark.parametrize("call", [
    lambda g, s: T.compare(g, T.ZCU102, trace=True, **CPU),
    lambda g, s: T.compare(g, T.ZCU102, static_check=True, **CPU),
    lambda g, s: T.run_with_remediation(s, static_precheck=True, **CPU),
    lambda g, s: ProfileCollector().attach_trace(),
], ids=["trace", "static_check", "static_precheck", "attach_trace"])
def test_unported_slices_raise(call):
    _, tg = deadlock_repro()
    with pytest.raises(NotImplementedError, match="not ported"):
        call(tg, T.compile_graph(tg, T.ZCU102))
