"""Parity of the PyTorch port's in-band profiling core with the JAX package.

Guard words (``xor24`` and ``crc32``) and bit-flip injection are bit-equal
to the reference's; streams, verified decodes, the fixed-point codec, the
shortcut tape, the metric taps, the collector and the routing planner
agree with it.
"""
import binascii
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

import repro.core as J
import repro_torch.core as T
from repro.core import metrics as jm
from repro_torch.core import metrics as tm


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def words(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(
        np.float32) * 100


def guarded_pair(records, algo):
    js, ts = J.ProfileStream.create(), T.ProfileStream.create(device="cpu")
    for i, vals in enumerate(records):
        js = js.append_guarded(f"sig{i}", "m", jnp.asarray(vals), algo=algo)
        ts = ts.append_guarded(f"sig{i}", "m", torch.from_numpy(vals),
                               algo=algo)
    return js, ts


def assert_streams_equal(ts, js):
    assert [dataclasses.astuple(lbl) for lbl in ts.schema] == [
        dataclasses.astuple(lbl) for lbl in js.schema]
    assert np.array_equal(bits(ts.data.numpy()), bits(js.data))


# --------------------------------------------------------------------- #
# guard words: bit-equal
# --------------------------------------------------------------------- #
floats32 = st.lists(
    st.floats(allow_nan=False, allow_infinity=False, width=32),
    min_size=1, max_size=12)


@settings(deadline=None, max_examples=12)
@given(floats32)
def test_property_xor24_checksum_bit_equal(values):
    v = np.asarray(values, np.float32)
    got = T.word_checksum(torch.from_numpy(v))
    assert got.dtype == torch.float32
    assert bits(got.numpy()) == bits(J.word_checksum(jnp.asarray(v)))
    assert T.verify_checksum(v, float(got))


@settings(deadline=None, max_examples=6)
@given(st.lists(st.floats(allow_nan=False, width=32), min_size=1,
                max_size=4))
def test_property_crc32_bit_equal_and_binascii(values):
    v = np.asarray(values, np.float32)
    got = T.word_crc32(torch.from_numpy(v))
    assert np.array_equal(bits(got.numpy()),
                          bits(J.word_crc32(jnp.asarray(v))))
    crc = binascii.crc32(v.astype("<f4").tobytes())
    assert [int(w) for w in got] == [crc & 0xFFFF, crc >> 16]
    assert T.verify_crc32(v, got.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_xor24_lengths_and_special_words(n):
    v = words(n, n)
    v[0] = -0.0
    if n > 2:
        v[1], v[2] = np.inf, np.float32(1e-45)  # inf and a subnormal
    assert bits(T.word_checksum(torch.from_numpy(v)).numpy()) == bits(
        J.word_checksum(jnp.asarray(v)))


def test_crc32_of_empty_payload_matches():
    v = np.zeros((0,), np.float32)
    assert [int(w) for w in T.word_crc32(torch.from_numpy(v))] == [0, 0]
    assert [int(w) for w in J.word_crc32(jnp.asarray(v))] == [0, 0]


@pytest.mark.parametrize("algo", ["xor24", "crc32"])
def test_guarded_streams_and_verified_decode_equal(algo):
    records = [words(i, 1 + i % 3) for i in range(4)]
    js, ts = guarded_pair(records, algo)
    assert_streams_equal(ts, js)
    cases = [
        (lambda s: s, "clean"),
        (lambda s: s.with_bitflip(2, 1 << 9), "flipped payload"),
        (lambda s: s.with_bitflip(3, 1 << 31), "flipped guard"),
        (lambda s: s.truncated(s.n_words - 2), "truncated"),
        (lambda s: s.truncated(0), "empty"),
    ]
    for damage, what in cases:
        jd, ts_d = damage(js), damage(ts)
        assert np.array_equal(bits(ts_d.data.numpy()), bits(jd.data)), what
        (jw, jrep), (tw, trep) = jd.decode_verified(), ts_d.decode_verified()
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep), what
        assert trep.summary() == jrep.summary()
        assert list(tw) == list(jw), what
        for k in jw:
            assert np.array_equal(tw[k], jw[k]), (what, k)


def test_split_merge_seq_restart_and_reorder_match():
    js, ts = guarded_pair([words(1, 2), words(2, 1)], "xor24")
    jb, tb = js.split(3), ts.split(3)
    jb = (jb[0], jb[1].append_guarded("b1", "m", jnp.float32(4.0)), jb[2])
    tb = (tb[0], tb[1].append_guarded("b1", "m", 4.0), tb[2])
    jm_, tm_ = J.ProfileStream.merge(*jb), T.ProfileStream.merge(*tb)
    assert_streams_equal(tm_, jm_)
    assert dataclasses.asdict(tm_.decode_verified()[1]) == (
        dataclasses.asdict(jm_.decode_verified()[1]))
    # records swapped in the word stream: a sequence break on both sides
    j_sw = J.ProfileStream.merge(*jb[::-1])
    t_sw = T.ProfileStream.merge(*tb[::-1])
    assert dataclasses.asdict(t_sw.decode_verified()[1]) == (
        dataclasses.asdict(j_sw.decode_verified()[1]))
    assert tm_.n_signals == jm_.n_signals and repr(tm_).startswith(
        "ProfileStream(words=")


def test_stream_create_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the stream would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ProfileStream.create()


# --------------------------------------------------------------------- #
# codec, tape, metrics
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("total,int_bits", [(6, None), (8, None), (12, 4),
                                             (16, 8), (32, 16), (3, 1)])
def test_fixed_point_codec_equal(total, int_bits):
    x = np.concatenate([np.linspace(-300, 300, 41, dtype=np.float32),
                        np.float32([0.5, 1.5, 2.5, -2.5, 1e9, -1e9, np.inf,
                                    -np.inf, np.nan])])
    jc = J.FixedPointCodec(total, int_bits)
    tc = T.FixedPointCodec(total, int_bits)
    assert (tc.max_value, tc.min_value, tc.scale, tc.frac_bits) == (
        jc.max_value, jc.min_value, jc.scale, jc.frac_bits)
    assert tc.storage_bytes_per_word == jc.storage_bytes_per_word
    q_t, q_j = tc.encode(torch.from_numpy(x)), jc.encode(jnp.asarray(x))
    assert str(q_t.dtype).split(".")[-1] == str(q_j.dtype)
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(tc.roundtrip(x).numpy(),
                          np.asarray(jc.roundtrip(jnp.asarray(x))))
    assert tc.decode(q_t).dtype == torch.float32
    assert np.array_equal(tc.overflows(x).numpy(),
                          np.asarray(jc.overflows(jnp.asarray(x))))


def test_tape_rows_equal_inline_and_reference():
    spec_j = J.TapeSpec(labels=(J.Label("rms", "act_rms", 1),
                                J.Label("v", "m", 2)))
    spec_t = T.TapeSpec(labels=(T.Label("rms", "act_rms", 1),
                                T.Label("v", "m", 2)))
    assert spec_t.offsets() == spec_j.offsets() and spec_t.width == 3
    rows = np.stack([np.float32([i, -1.0, -1.0]) for i in range(4)])
    for i in range(4):
        got = spec_t.emit({"rms": torch.tensor(float(i))})
        want = spec_j.emit({"rms": jnp.float32(i)})
        assert np.array_equal(got.numpy(), np.asarray(want))
    head_j = J.ProfileStream.create().append("h", "m", 1.0)
    head_t = T.ProfileStream.create(device="cpu").append("h", "m", 1.0)
    tail_j = J.ProfileStream.create().append("t", "m", 2.0)
    tail_t = T.ProfileStream.create(device="cpu").append("t", "m", 2.0)
    assert_streams_equal(
        T.concat_streams_and_rows(head_t, spec_t, torch.from_numpy(rows),
                                  tail_t),
        J.concat_streams_and_rows(head_j, spec_j, jnp.asarray(rows), tail_j))
    with pytest.raises(ValueError):
        T.rows_to_stream(spec_t, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        spec_t.emit({"v": torch.zeros(3)})


def test_metric_taps_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    for name in ("act_rms", "act_absmax", "logit_max"):
        np.testing.assert_allclose(
            getattr(tm, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jm, name)(jnp.asarray(x))), rtol=1e-6)
    counts = np.int32([0, 3, 9, 12])
    for got, want in zip(tm.expert_fullness(torch.from_numpy(counts), 8),
                         jm.expert_fullness(jnp.asarray(counts), 8)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(
        tm.kv_occupancy(torch.tensor([3, 17, 5]), 64).numpy(),
        np.asarray(jm.kv_occupancy(jnp.asarray([3, 17, 5]), 64)))
    grads = {"a": x, "b": [x[0], x[1:]]}
    np.testing.assert_allclose(
        tm.grad_global_norm({"a": torch.from_numpy(x),
                             "b": [torch.from_numpy(x[0]),
                                   torch.from_numpy(x[1:])]}).numpy(),
        np.asarray(jm.grad_global_norm(
            {k: jnp.asarray(v) if not isinstance(v, list)
             else [jnp.asarray(u) for u in v] for k, v in grads.items()})),
        rtol=1e-6)


# --------------------------------------------------------------------- #
# collector and routing plans
# --------------------------------------------------------------------- #
def test_collector_aggregates_equal():
    jc, tc = J.ProfileCollector(), T.ProfileCollector()
    for step in range(3):
        vals = words(step, 3)
        js = J.ProfileStream.create().append_guarded("fifo", "m",
                                                     jnp.asarray(vals))
        ts = T.ProfileStream.create(device="cpu").append_guarded(
            "fifo", "m", torch.from_numpy(vals))
        if step == 1:
            js, ts = js.with_bitflip(0), ts.with_bitflip(0)
        jc.ingest_verified(js)
        tc.ingest_verified(ts)
        jc.ingest(J.ProfileStream.create().append("plain", "m", float(step)))
        tc.ingest(T.ProfileStream.create(device="cpu").append(
            "plain", "m", float(step)))
    assert tc.report() == jc.report()
    assert tc.to_json() == jc.to_json()
    assert (tc.steps, tc.integrity_failures, tc.quarantine_counts) == (
        jc.steps, jc.integrity_failures, jc.quarantine_counts)
    assert dataclasses.asdict(tc.last_integrity) == dataclasses.asdict(
        jc.last_integrity)
    for stat in ("max", "min", "last", "mean"):
        got, want = tc.summary(stat), jc.summary(stat)
        assert list(got) == list(want)
        for k in want:
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("policy", ["inline", "shortcut"])
@pytest.mark.parametrize("rule", ["first", "balance"])
def test_plan_routing_equal(policy, rule):
    nodes = [("a", 1), ("b", 2), ("c", 1), ("d", 0), ("e", 3), ("f", 1)]
    edges = [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d"), ("a", "e"),
             ("d", "f"), ("e", "f")]
    jd = J.ProfiledDag(tuple(J.DagNode(n, r) for n, r in nodes),
                       tuple(edges))
    td = T.ProfiledDag(tuple(T.DagNode(n, r) for n, r in nodes),
                       tuple(edges))
    kw = dict(policy=policy, split_rule=rule, shortcut_threshold=2)
    assert dataclasses.asdict(T.plan_routing(td, **kw)) == (
        dataclasses.asdict(J.plan_routing(jd, **kw)))
    assert T.validate_policy(policy) == policy
    with pytest.raises(ValueError):
        T.validate_policy("sometimes")
