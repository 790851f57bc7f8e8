"""Batch-many runtime for the streaming dataflow simulator, in PyTorch.

The port of :mod:`repro.rinn.batchsim`.  The machine is split, as there,
into two groups of arrays:

  * :class:`MachineOps` — the padded dataflow machine (topology, beat
    counts, timing), padded to a :class:`ShapeBucket` ``(N, E, MAX_IN,
    MAX_OUT, S)`` of powers of two so that different machines can share
    one batch;
  * :class:`FaultOps` — everything that varies between runs of one
    machine: per-edge capacities (base + plan faults + remediation
    overrides), stall windows, drop/dup beat indices, profile-word
    corruption (cycle, mask), the ``profiled`` flag and the loop bounds.

JAX's ``vmap`` becomes a lane dimension written out: the state of B runs is
``[B, E+1]`` per edge and ``[B, N]`` per actor.  ``run_sim_batch`` shares
one machine across the lanes (a machine dimension of 1, broadcast);
``run_sim_many`` stacks one machine per lane, ``[B, N, MAX_IN]``.

Lanes freeze when they finish, as under JAX's batched ``while_loop``: each
step computes ``active`` per lane from the loop condition and keeps every
state tensor of an inactive lane unchanged.  So a lane's result does not
depend on its neighbours and batched results equal sequential ones.

Padding is inert: padded actors have ``total_in = total_out = 0`` so they
never fire and count as finished; padded edges are referenced by no actor
and carry infinite capacity.  All state is int32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .streamsim import CompiledSim, FaultPlan, SimResult

Edge = Tuple[str, str]

_INF_CAP = np.iinfo(np.int32).max // 2

# The host reads ``active.any()`` (a device sync) once every CHECK_EVERY
# cycles, not every cycle.  That stays exact because inactive lanes are
# frozen: the at most CHECK_EVERY - 1 steps run after the last lane
# finished change nothing.  8 keeps the wasted steps under ~5% of the
# 130-250 cycle runs of the paper's designs while cutting the syncs, each
# of which drains the card's launch queue, eightfold.
CHECK_EVERY = 8


# --------------------------------------------------------------------- #
# shape buckets
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """Padded machine shape ``(N, E, MAX_IN, MAX_OUT, S)``."""

    n: int
    e: int
    max_in: int
    max_out: int
    s: int


def _pow2_at_least(value: int, floor: int) -> int:
    return max(floor, 1 << max(0, value - 1).bit_length())


def machine_bucket(sim: CompiledSim, stall_slots: int = 1) -> ShapeBucket:
    """The shape bucket a compiled machine pads into.

    Machines in one bucket batch together in :func:`run_sim_many`; the
    floors (8 nodes/edges, 4 stall slots) are the reference's.
    """
    return ShapeBucket(
        n=_pow2_at_least(len(sim.node_ids), 8),
        e=_pow2_at_least(len(sim.edge_list), 8),
        max_in=_pow2_at_least(sim.in_edges.shape[1], 2),
        max_out=_pow2_at_least(sim.out_edges.shape[1], 2),
        s=_pow2_at_least(stall_slots, 4),
    )


def _stall_slots(plan: FaultPlan) -> int:
    counts: Dict[str, int] = {}
    for s in plan.stalls:
        counts[s.node] = counts.get(s.node, 0) + 1
    return max(counts.values(), default=1)


# --------------------------------------------------------------------- #
# packed machine and fault arrays
# --------------------------------------------------------------------- #
class MachineOps(NamedTuple):
    """Padded machine arrays (numpy when packed; tensors with a leading
    machine dimension once on the device)."""

    in_edges: np.ndarray    # [N, MAX_IN] edge index, dummy = E (pad slot)
    out_edges: np.ndarray   # [N, MAX_OUT]
    total_in: np.ndarray    # [N]
    total_out: np.ndarray   # [N]
    fill: np.ndarray        # [N]
    ii: np.ndarray          # [N]
    extra_lat: np.ndarray   # [N]
    is_src: np.ndarray      # [N] bool
    prof: np.ndarray        # [N] bool — consumer-side SPRING tap
    pf_period: np.ndarray   # scalar
    pf_stall: np.ndarray    # scalar
    source_ii: np.ndarray   # scalar


class FaultOps(NamedTuple):
    """Per-run arrays: fault plan + capacities + flags + loop bounds."""

    cap: np.ndarray         # [E+1] per-edge capacity (dummy slot = inf)
    st_start: np.ndarray    # [N, S] stall window starts (-1 = none)
    st_end: np.ndarray      # [N, S]
    drop_beat: np.ndarray   # [E+1] beat index to drop (-1 = none)
    dup_beat: np.ndarray    # [E+1]
    cor_cycle: np.ndarray   # [E+1] profile-word corruption cycle (-1 = none)
    cor_mask: np.ndarray    # [E+1]
    profiled: np.ndarray    # scalar bool — in-band profiler attached
    idle_limit: np.ndarray  # scalar
    max_cycles: np.ndarray  # scalar


def pack_machine(sim: CompiledSim, bucket: ShapeBucket) -> MachineOps:
    """Pad the compiled machine into its bucket (numpy)."""
    N, E = len(sim.node_ids), len(sim.edge_list)

    def pad_n(src, fill_value, dtype):
        out = np.full(bucket.n, fill_value, dtype)
        out[:N] = src
        return out

    in_edges = np.full((bucket.n, bucket.max_in), bucket.e, np.int32)
    in_edges[:N, :sim.in_edges.shape[1]] = np.where(
        sim.in_edges >= E, bucket.e, sim.in_edges)
    out_edges = np.full((bucket.n, bucket.max_out), bucket.e, np.int32)
    out_edges[:N, :sim.out_edges.shape[1]] = np.where(
        sim.out_edges >= E, bucket.e, sim.out_edges)
    return MachineOps(
        in_edges=in_edges, out_edges=out_edges,
        total_in=pad_n(sim.total_in, 0, np.int32),
        total_out=pad_n(sim.total_out, 0, np.int32),
        fill=pad_n(sim.fill, 0, np.int32),
        ii=pad_n(sim.ii, 1, np.int32),
        extra_lat=pad_n(sim.extra_lat, 0, np.int32),
        is_src=pad_n(sim.is_source, False, bool),
        prof=pad_n(sim.profiled, False, bool),
        pf_period=np.int32(sim.pf_period),
        pf_stall=np.int32(sim.pf_stall),
        source_ii=np.int32(sim.source_ii),
    )


def pack_faults(
    sim: CompiledSim, bucket: ShapeBucket, plan: FaultPlan,
    capacity_overrides: Optional[Dict[Edge, int]], profiled: bool,
    max_cycles: int,
) -> Tuple[FaultOps, np.ndarray, int]:
    """Lower one run's variable inputs to arrays.

    Returns ``(ops, cap_np, idle_limit)`` — ``cap_np`` and ``idle_limit``
    are kept host-side for result reporting / deadlock classification.
    """
    N, E = len(sim.node_ids), len(sim.edge_list)
    eidx = {e: i for i, e in enumerate(sim.edge_list)}
    node_of = {nid: i for i, nid in enumerate(sim.node_ids)}

    # capacity: base, then plan faults, then remediation overrides (win)
    cap = np.full(bucket.e + 1, _INF_CAP, np.int32)
    cap[:E] = sim.capacity
    for cf in plan.capacities:
        cap[eidx[cf.edge]] = cf.capacity
    for e, c in (capacity_overrides or {}).items():
        cap[eidx[e]] = c

    st_start = np.full((bucket.n, bucket.s), -1, np.int32)
    st_end = np.full((bucket.n, bucket.s), -1, np.int32)
    slot: Dict[str, int] = {}
    for s in plan.stalls:
        i, k = node_of[s.node], slot.get(s.node, 0)
        st_start[i, k], st_end[i, k] = s.start, s.start + s.duration
        slot[s.node] = k + 1

    drop_beat = np.full(bucket.e + 1, -1, np.int32)
    dup_beat = np.full(bucket.e + 1, -1, np.int32)
    for bf in plan.drops:
        drop_beat[eidx[bf.edge]] = bf.beat
    for bf in plan.dups:
        dup_beat[eidx[bf.edge]] = bf.beat

    cor_cycle = np.full(bucket.e + 1, -1, np.int32)
    cor_mask = np.zeros(bucket.e + 1, np.int32)
    for wc in plan.corruptions:
        cor_cycle[eidx[wc.edge]] = wc.cycle
        cor_mask[eidx[wc.edge]] = wc.bitmask

    # longest legitimate quiet period: ii timers, source cadence, profiling
    # stalls, drain latency, and any injected stall window
    idle_limit = int(
        2 * (int(sim.ii.max(initial=1)) + sim.source_ii + sim.pf_stall)
        + int(sim.extra_lat.max(initial=0)) + plan.max_stall() + 16)

    ops = FaultOps(
        cap=cap, st_start=st_start, st_end=st_end,
        drop_beat=drop_beat, dup_beat=dup_beat,
        cor_cycle=cor_cycle, cor_mask=cor_mask,
        profiled=np.bool_(profiled),
        idle_limit=np.int32(idle_limit),
        max_cycles=np.int32(max_cycles),
    )
    return ops, cap, idle_limit


def _stack(trees, device: torch.device):
    """Stack packed numpy groups into one group of tensors on ``device``
    with a leading lane (or machine) dimension."""
    cls = type(trees[0])
    return cls(*[torch.from_numpy(np.stack(leaves)).to(device)
                 for leaves in zip(*trees)])


# --------------------------------------------------------------------- #
# the simulator core
# --------------------------------------------------------------------- #
_STATS = {"traces": 0, "launches": 0, "lanes": 0}


def compile_stats() -> Dict[str, int]:
    """Launch counters, with the reference's keys.

    ``launches`` counts simulator runs (a batch of B lanes is one);
    ``lanes`` counts simulated runs (a batch of B adds B).  ``traces``
    counts nothing here and stays 0: PyTorch runs eagerly and compiles
    nothing per machine shape, where JAX re-traces its ``while_loop``.
    """
    return dict(_STATS)


def reset_compile_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def _simulate(m: MachineOps, f: FaultOps) -> List[torch.Tensor]:
    """Step B lanes to completion; ``m`` has a machine dimension of 1
    (shared) or B, ``f`` a lane dimension of B.

    Mirrors the reference's cycle body line by line (``batchsim.py``
    ``_simulate``); the comments name the points where torch differs.
    """
    B, e_slots = f.cap.shape  # E_pad + 1; last slot is the dummy edge
    dummy = e_slots - 1
    n_pad, max_in = m.in_edges.shape[1:]
    max_out = m.out_edges.shape[2]
    i32 = torch.int32
    dev = f.cap.device

    # flat gather/scatter indices, expanded (not copied) to every lane
    in_idx = m.in_edges.reshape(m.in_edges.shape[0], -1).expand(B, -1)
    out_idx = m.out_edges.reshape(m.out_edges.shape[0], -1).expand(B, -1)
    in_mask = m.in_edges < dummy                          # [Bm, N, MAX_IN]
    out_mask = m.out_edges < dummy
    out_cap = torch.gather(f.cap, 1, out_idx).view(B, n_pad, max_out)
    prof_node = m.prof & f.profiled[:, None]              # [B, N]
    total_in, total_out, fill, ii = m.total_in, m.total_out, m.fill, m.ii
    is_src = m.is_src
    pf_period = m.pf_period[:, None]
    pf_stall = m.pf_stall[:, None]
    source_ii = m.source_ii[:, None]
    rate_is_one = total_out == total_in
    safe_in = total_in.clamp_min(1)

    cyc = torch.zeros(B, dtype=i32, device=dev)
    fifo = torch.zeros(B, e_slots, dtype=i32, device=dev)
    fifo[:, dummy] = 1
    consumed = torch.zeros(B, n_pad, dtype=i32, device=dev)
    produced = torch.zeros_like(consumed)
    ii_t = torch.zeros_like(consumed)
    drain_t = m.extra_lat.expand(B, -1).clone()
    src_t = torch.zeros_like(consumed)
    maxf = fifo.clone()
    profmax = torch.zeros_like(fifo)
    epush = torch.zeros_like(fifo)
    idle = torch.zeros_like(cyc)

    for step in itertools.count():
        # the loop condition, per lane; JAX's batched while_loop runs the
        # body while any lane holds it and keeps the other lanes unchanged
        done = (produced >= total_out).all(1)
        active = ~done & (cyc < f.max_cycles) & (idle < f.idle_limit)
        if step % CHECK_EVERY == 0 and not bool(active.any()):
            break

        cyc3 = cyc[:, None, None]
        stalled = ((cyc3 >= f.st_start) & (cyc3 < f.st_end)).any(2)
        in_counts = torch.gather(fifo, 1, in_idx).view(B, n_pad, max_in)
        in_avail = ((in_counts >= 1) | ~in_mask).all(2)
        consume = (in_avail & (ii_t == 0) & (consumed < total_in)
                   & ~is_src & ~stalled)

        # SPRING sampling: data.size() read immediately before data.read();
        # JAX's .at[].max is a scatter "amax" onto zeros
        read_now = consume & prof_node
        sampled = torch.zeros_like(fifo).scatter_reduce_(
            1, in_idx,
            torch.where(in_mask & read_now[:, :, None], in_counts, 0)
            .reshape(B, -1),
            "amax", include_self=True)
        new_profmax = torch.maximum(profmax, sampled)

        consumed_next = consumed + consume.to(i32)

        # pipeline allowance: total_in beats map to total_out beats at rate
        # out/in after the fill; floor division of non-negative ints
        done_in = consumed_next >= total_in
        prog = (consumed_next - fill).clamp_min(0)
        rate_allowed = torch.where(
            rate_is_one, prog,
            torch.div(prog * total_out, safe_in, rounding_mode="floor"))
        allowed = torch.where(
            done_in, total_out,
            torch.minimum(rate_allowed.clamp_min(0), total_out))
        allowed = torch.where(is_src, total_out, allowed)

        # the space check reads start-of-cycle occupancy
        out_counts = torch.gather(fifo, 1, out_idx).view(B, n_pad, max_out)
        out_space = ((out_counts < out_cap) | ~out_mask).all(2)
        src_ready = (src_t == 0) | ~is_src
        produce = ((produced < allowed) & out_space & src_ready
                   & (drain_t == 0) & (produced < total_out) & ~stalled)

        # JAX's .at[].add is a scatter_add_ onto zeros
        pops = torch.zeros_like(fifo).scatter_add_(
            1, in_idx, (in_mask & consume[:, :, None]).reshape(B, -1).to(i32))
        pushes = torch.zeros_like(fifo).scatter_add_(
            1, out_idx,
            (out_mask & produce[:, :, None]).reshape(B, -1).to(i32))
        # wire faults hit on epush *before* its increment
        will_push = pushes > 0
        drop_hit = will_push & (epush == f.drop_beat)
        dup_hit = will_push & (epush == f.dup_beat)
        pushes = pushes - drop_hit.to(i32) + dup_hit.to(i32)
        new_epush = epush + will_push.to(i32)
        new_fifo = fifo - pops + pushes
        new_fifo[:, dummy] = 1  # the dummy slot is re-pinned every cycle
        new_maxf = torch.maximum(maxf, new_fifo)

        # in-fabric bit flip of the stored profile word, after the max
        new_profmax = torch.where(f.cor_cycle == cyc[:, None],
                                  new_profmax ^ f.cor_mask, new_profmax)

        new_produced = produced + produce.to(i32)

        # profiling interference (Listing 2): every pf_period-th firing of a
        # profiled node costs pf_stall extra cycles before the next consume
        stall = torch.where(
            prof_node & consume & (consumed_next % pf_period == 0),
            pf_stall, 0)
        new_ii_t = torch.where(consume, ii - 1 + stall,
                               (ii_t - 1).clamp_min(0))
        new_drain_t = torch.where(done_in & (drain_t > 0), drain_t - 1,
                                  drain_t)
        new_src_t = torch.where(is_src & produce, source_ii - 1,
                                (src_t - 1).clamp_min(0))
        fired = consume.any(1) | produce.any(1)
        new_idle = torch.where(fired, 0, idle + 1)

        # freeze finished lanes, every state tensor included
        a = active[:, None]
        cyc = torch.where(active, cyc + 1, cyc)
        idle = torch.where(active, new_idle, idle)
        fifo = torch.where(a, new_fifo, fifo)
        consumed = torch.where(a, consumed_next, consumed)
        produced = torch.where(a, new_produced, produced)
        ii_t = torch.where(a, new_ii_t, ii_t)
        drain_t = torch.where(a, new_drain_t, drain_t)
        src_t = torch.where(a, new_src_t, src_t)
        maxf = torch.where(a, new_maxf, maxf)
        profmax = torch.where(a, new_profmax, profmax)
        epush = torch.where(a, new_epush, epush)

    return [cyc, fifo, consumed, produced, maxf, profmax, idle]


def _run(machine: MachineOps, faults: FaultOps) -> List[np.ndarray]:
    _STATS["launches"] += 1
    _STATS["lanes"] += int(faults.cap.shape[0])
    return [o.cpu().numpy() for o in _simulate(machine, faults)]


# --------------------------------------------------------------------- #
# host-side result assembly
# --------------------------------------------------------------------- #
def _unpack(sim: CompiledSim, cap_np: np.ndarray, plan: Optional[FaultPlan],
            profiled: bool, idle_limit: int, outs) -> SimResult:
    cyc, fifo, consumed, produced, maxf, profmax, idle = outs
    N = len(sim.node_ids)
    node_of = {nid: i for i, nid in enumerate(sim.node_ids)}
    completed = bool((produced[:N] >= sim.total_out).all())
    fifo_max, fifo_prof, ctype, ffinal, fcap = {}, {}, {}, {}, {}
    for k, (s, d) in enumerate(sim.edge_list):
        fifo_max[(s, d)] = int(maxf[k])
        ctype[(s, d)] = sim.layer_type[d]
        ffinal[(s, d)] = int(fifo[k])
        fcap[(s, d)] = int(cap_np[k])
        if profiled and sim.profiled[node_of[d]]:
            fifo_prof[(s, d)] = int(profmax[k])
    idle_cycles = int(idle)
    return SimResult(
        completed=completed, cycles=int(cyc),
        fifo_max=fifo_max, fifo_profiled=fifo_prof, consumer_type=ctype,
        deadlocked=(not completed) and idle_cycles >= idle_limit,
        idle_cycles=idle_cycles,
        fifo_final=ffinal, fifo_capacity=fcap,
        node_consumed={n: int(consumed[i])
                       for i, n in enumerate(sim.node_ids)},
        node_produced={n: int(produced[i])
                       for i, n in enumerate(sim.node_ids)},
        faults=plan,
    )


# --------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------- #
def run_sim_single(
    sim: CompiledSim, profiled: bool = False, max_cycles: int = 200_000,
    faults: Optional[FaultPlan] = None,
    capacity_overrides: Optional[Dict[Edge, int]] = None,
    *, device=None,
) -> SimResult:
    """One run (the engine behind ``run_sim``)."""
    dev = resolve_device(device)
    plan = faults or FaultPlan()
    bucket = machine_bucket(sim, _stall_slots(plan))
    ops, cap_np, idle_limit = pack_faults(
        sim, bucket, plan, capacity_overrides, profiled, max_cycles)
    outs = _run(_stack([pack_machine(sim, bucket)], dev), _stack([ops], dev))
    return _unpack(sim, cap_np, faults, profiled, idle_limit,
                   [o[0] for o in outs])


def _broadcast(value, n: int, name: str) -> list:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{name} has {len(value)} entries, expected {n}")
        return list(value)
    return [value] * n


def run_sim_batch(
    sim: CompiledSim, *,
    plans: Union[None, FaultPlan, Sequence[Optional[FaultPlan]]] = None,
    capacity_overrides: Union[
        None, Dict[Edge, int], Sequence[Optional[Dict[Edge, int]]]] = None,
    profiled: Union[bool, Sequence[bool]] = False,
    max_cycles: Union[int, Sequence[int]] = 200_000,
    n: Optional[int] = None,
    device=None,
) -> List[SimResult]:
    """Run B fault/capacity/profiled lanes of one machine as one batch.

    Any of ``plans`` / ``capacity_overrides`` / ``profiled`` / ``max_cycles``
    may be a sequence (all sequences must agree on length) or a scalar
    (broadcast).  ``n`` forces the lane count when everything is scalar.
    Results equal calling :func:`run_sim_single` per lane.
    """
    dev = resolve_device(device)
    lengths = [len(v) for v in (plans, capacity_overrides, profiled,
                                max_cycles)
               if isinstance(v, (list, tuple))]
    if n is None:
        n = max(lengths) if lengths else 1
    plans_l = _broadcast(plans, n, "plans")
    caps_l = _broadcast(capacity_overrides, n, "capacity_overrides")
    prof_l = _broadcast(profiled, n, "profiled")
    mc_l = _broadcast(max_cycles, n, "max_cycles")
    if n == 1:
        return [run_sim_single(sim, profiled=prof_l[0], max_cycles=mc_l[0],
                               faults=plans_l[0],
                               capacity_overrides=caps_l[0], device=dev)]

    stall_slots = max(_stall_slots(p or FaultPlan()) for p in plans_l)
    bucket = machine_bucket(sim, stall_slots)
    packed = [pack_faults(sim, bucket, p or FaultPlan(), c, pr, mc)
              for p, c, pr, mc in zip(plans_l, caps_l, prof_l, mc_l)]
    outs = _run(_stack([pack_machine(sim, bucket)], dev),
                _stack([ops for ops, _, _ in packed], dev))
    return [
        _unpack(sim, packed[b][1], plans_l[b], prof_l[b], packed[b][2],
                [o[b] for o in outs])
        for b in range(n)
    ]


def run_sim_many(
    sims: Sequence[CompiledSim], *,
    plans: Union[None, Sequence[Optional[FaultPlan]]] = None,
    capacity_overrides: Union[
        None, Sequence[Optional[Dict[Edge, int]]]] = None,
    profiled: Union[bool, Sequence[bool]] = False,
    max_cycles: Union[int, Sequence[int]] = 200_000,
    device=None,
) -> List[SimResult]:
    """Simulate many *different* machines, batching those that share a
    shape bucket into one run with a machine per lane.

    Machines alone in their bucket take the single-run path.  Results
    come back in input order.
    """
    dev = resolve_device(device)
    n = len(sims)
    plans_l = _broadcast(plans, n, "plans")
    caps_l = _broadcast(capacity_overrides, n, "capacity_overrides")
    prof_l = _broadcast(profiled, n, "profiled")
    mc_l = _broadcast(max_cycles, n, "max_cycles")
    stall_slots = max(_stall_slots(p or FaultPlan()) for p in plans_l)

    groups: Dict[ShapeBucket, List[int]] = {}
    for i, sim in enumerate(sims):
        groups.setdefault(machine_bucket(sim, stall_slots), []).append(i)

    results: List[Optional[SimResult]] = [None] * n
    for bucket, idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            results[i] = run_sim_single(
                sims[i], profiled=prof_l[i], max_cycles=mc_l[i],
                faults=plans_l[i], capacity_overrides=caps_l[i], device=dev)
            continue
        machines = _stack([pack_machine(sims[i], bucket) for i in idxs], dev)
        packed = [pack_faults(sims[i], bucket, plans_l[i] or FaultPlan(),
                              caps_l[i], prof_l[i], mc_l[i]) for i in idxs]
        outs = _run(machines, _stack([ops for ops, _, _ in packed], dev))
        for b, i in enumerate(idxs):
            results[i] = _unpack(
                sims[i], packed[b][1], plans_l[i], prof_l[i], packed[b][2],
                [o[b] for o in outs])
    return results  # type: ignore[return-value]
