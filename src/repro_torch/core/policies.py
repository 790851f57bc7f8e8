"""Stream-handling policies over a profiled dataflow DAG.

The paper (§II.A) leaves the stream-handling policy pluggable: "balancing the
lengths of split profiling streams to reduce resource usage, or creating
shortcuts to directly forward sufficiently long profiling streams to the
dataflow's final merging module while inserting a new placeholder at their
original location.  Once these stream-handling policies are defined, a
predetermined output profiling label list can be generated."

This module plans routing over an abstract DAG and prices it with the
word-copy cost model (each module re-reads and re-writes every word of its
incoming profile stream — the paper's §III.A inefficiency).  The plan yields
(a) the static output label order and (b) the total number of word copies,
so policies can be compared quantitatively (benchmarks/fig3_overhead.py).
Pure Python: the port's copy of :mod:`repro.core.policies`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class DagNode:
    """One profiled module in the dataflow graph."""

    node_id: str
    record_size: int = 1  # words this node appends (0 = not profiled)


@dataclasses.dataclass(frozen=True)
class ProfiledDag:
    """DAG with deterministic input ordering at merges (paper's merge rule)."""

    nodes: Tuple[DagNode, ...]
    edges: Tuple[Tuple[str, str], ...]  # (src, dst), dst-input order = list order

    def __post_init__(self):
        ids = [n.node_id for n in self.nodes]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate node ids")
        idset = set(ids)
        for s, d in self.edges:
            if s not in idset or d not in idset:
                raise ValueError(f"edge ({s},{d}) references unknown node")

    def successors(self, nid: str) -> List[str]:
        return [d for s, d in self.edges if s == nid]

    def predecessors(self, nid: str) -> List[str]:
        return [s for s, d in self.edges if d == nid]

    def sink(self) -> str:
        sinks = [n.node_id for n in self.nodes if not self.successors(n.node_id)]
        if len(sinks) != 1:
            raise ValueError(f"DAG must have exactly one sink, found {sinks}")
        return sinks[0]

    def topo_order(self) -> List[str]:
        indeg = {n.node_id: 0 for n in self.nodes}
        for _, d in self.edges:
            indeg[d] += 1
        frontier = [nid for nid, k in sorted(indeg.items()) if k == 0]
        order: List[str] = []
        while frontier:
            nid = frontier.pop(0)
            order.append(nid)
            for d in self.successors(nid):
                indeg[d] -= 1
                if indeg[d] == 0:
                    frontier.append(d)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order


@dataclasses.dataclass
class RoutingPlan:
    """Result of planning: static label order + cost accounting."""

    label_order: List[str]          # final positional label list at the sink
    word_copies: int                # total profile-word copies in the design
    max_stream_words: int           # widest stream any module carries
    shortcuts: List[Tuple[str, int]]  # (node where forwarded, words forwarded)
    policy: str


def plan_routing(
    dag: ProfiledDag,
    policy: str = "inline",
    split_rule: str = "first",
    shortcut_threshold: int = 8,
) -> RoutingPlan:
    """Plan profile-stream routing through ``dag``.

    policy:
      * ``inline``   — paper's implemented mechanism: streams carried through
                       every module; splits follow ``split_rule``.
      * ``shortcut`` — streams whose length reaches ``shortcut_threshold`` at
                       a module input are forwarded directly to the sink (one
                       final copy), a placeholder taking their place.
    split_rule:
      * ``first``    — all profile words follow the first successor (paper);
      * ``balance``  — words follow the successor with the smallest total
                       downstream record load (paper's proposed balancing).
    """
    if policy not in ("inline", "shortcut"):
        raise ValueError(f"unknown policy {policy!r}")
    if split_rule not in ("first", "balance"):
        raise ValueError(f"unknown split_rule {split_rule!r}")

    rec = {n.node_id: n.record_size for n in dag.nodes}
    order = dag.topo_order()
    sink = dag.sink()

    # Downstream record load (for the balancing rule): total words appended by
    # all nodes reachable from nid, inclusive.
    load: Dict[str, int] = {}
    for nid in reversed(order):
        load[nid] = rec[nid] + sum(load[s] for s in dag.successors(nid))

    # Streams are label lists; placeholder labels are single words.
    stream_at: Dict[Tuple[str, str], List[str]] = {}  # per-edge stream
    forwarded: List[Tuple[str, List[str]]] = []       # shortcut payloads
    shortcuts: List[Tuple[str, int]] = []
    word_copies = 0
    max_stream = 0

    for nid in order:
        preds = dag.predecessors(nid)
        # merge rule: concatenate incoming streams in input order
        incoming: List[str] = []
        for p in preds:
            seg = stream_at.pop((p, nid), [])
            if policy == "shortcut" and len(seg) >= shortcut_threshold and nid != sink:
                forwarded.append((nid, seg))
                shortcuts.append((nid, len(seg)))
                word_copies += len(seg)  # one final direct copy to the sink
                seg = [f"__placeholder@{p}->{nid}__"]
            incoming.extend(seg)
        # this module re-reads + re-writes every incoming word
        word_copies += len(incoming)
        out_stream = incoming + [f"{nid}[{i}]" for i in range(rec[nid])]
        max_stream = max(max_stream, len(out_stream))

        succs = dag.successors(nid)
        if not succs:
            final_stream = out_stream
            continue
        if len(succs) == 1:
            primary = succs[0]
        elif split_rule == "first":
            primary = succs[0]
        else:  # balance: carry along the successor with the least downstream load
            primary = min(succs, key=lambda s: (load[s], succs.index(s)))
        for b, s in enumerate(succs):
            if s == primary:
                stream_at[(nid, s)] = out_stream
            else:
                stream_at[(nid, s)] = [f"__placeholder@{nid}->{s}__"]

    # shortcut payloads land at the sink after the carried stream (stable order)
    for _, seg in forwarded:
        final_stream = final_stream + seg

    return RoutingPlan(
        label_order=final_stream,
        word_copies=word_copies,
        max_stream_words=max_stream,
        shortcuts=shortcuts,
        policy=policy,
    )
