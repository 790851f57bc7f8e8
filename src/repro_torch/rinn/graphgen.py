"""Randomly Interconnected Neural Network generator (paper §II.B).

Faithful to the paper's construction: the original 16-element input passes
through a Dense layer sized to the target image, a Reshape to (x, x, 1), a
stack of same-shape Conv2D layers with random inter-connections (merges via
Add/Concat, fan-outs via explicit hls4ml-style Clone nodes), then Flatten and
a Dense(5, sigmoid) head "compatible with the MNIST dataset".  A second
family uses only Dense/Add/Concat/ReLU/Sigmoid (§III.C.3).

Connection strategies reproduce §III.C.4:
  * ``density``    — every forward pair (i → j, j > i+1) wired w.p. density;
  * ``short_skip`` — skips of span ≤ 2;
  * ``long_skip``  — skips of span ≥ n_conv // 2;
  * ``ends_only``  — most layers connect only to the first/last few layers.

Everything is seeded and deterministic.  The port keeps its own copy of
:mod:`repro.rinn.graphgen` and numpy's ``default_rng``, so both packages
build identical node and edge lists from one ``RinnConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .layers import (AddSpec, CloneSpec, ConcatSpec, Conv2DSpec, DenseSpec, FlattenSpec, InputSpec, LayerSpec, ReshapeSpec, Shape)

PATTERNS = ("density", "short_skip", "long_skip", "ends_only")


@dataclasses.dataclass
class RinnGraph:
    """A DAG of layer specs; dst input order = edge insertion order."""

    nodes: Dict[str, LayerSpec]          # insertion-ordered
    edges: List[Tuple[str, str]]

    # ------------------------------------------------------------------ #
    def predecessors(self, nid: str) -> List[str]:
        return [s for s, d in self.edges if d == nid]

    def successors(self, nid: str) -> List[str]:
        return [d for s, d in self.edges if s == nid]

    def input_id(self) -> str:
        return next(n for n, s in self.nodes.items() if isinstance(s, InputSpec))

    def sink_id(self) -> str:
        sinks = [n for n in self.nodes if not self.successors(n)]
        if len(sinks) != 1:
            raise ValueError(f"expected one sink, got {sinks}")
        return sinks[0]

    def topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        for _, d in self.edges:
            indeg[d] += 1
        frontier = [n for n in self.nodes if indeg[n] == 0]
        order: List[str] = []
        while frontier:
            n = frontier.pop(0)
            order.append(n)
            for d in self.successors(n):
                indeg[d] -= 1
                if indeg[d] == 0:
                    frontier.append(d)
        if len(order) != len(self.nodes):
            raise ValueError("cycle in RINN graph")
        return order

    def shapes(self) -> Dict[str, Shape]:
        """Output shape of every node (validates wiring)."""
        out: Dict[str, Shape] = {}
        for nid in self.topo_order():
            spec = self.nodes[nid]
            ins = [out[p] for p in self.predecessors(nid)]
            out[nid] = spec.out_shape(ins) if ins else spec.out_shape([])
        return out

    def validate(self) -> None:
        seen = set()
        for (s, d) in self.edges:
            if s == d:
                raise ValueError(f"self-loop edge {s} -> {d}")
            if s not in self.nodes or d not in self.nodes:
                raise ValueError(f"edge {s} -> {d} references unknown node")
            if (s, d) in seen:
                raise ValueError(f"duplicate edge {s} -> {d}")
            seen.add((s, d))
        # every node must be fed (transitively) by the input, or it can
        # never fire and any merge downstream of it deadlocks (checked
        # before shapes(): an unfed node has no input shapes to infer)
        inputs = [n for n, s in self.nodes.items()
                  if isinstance(s, InputSpec)]
        if not inputs:
            raise ValueError("graph has no InputSpec node")
        live, frontier = set(), inputs
        while frontier:
            n = frontier.pop()
            if n in live:
                continue
            live.add(n)
            frontier.extend(self.successors(n))
        dead = [n for n in self.nodes if n not in live]
        if dead:
            raise ValueError(f"node(s) unreachable from input: {dead}")
        self.shapes()
        for nid, spec in self.nodes.items():
            n_in = len(self.predecessors(nid))
            n_out = len(self.successors(nid))
            if isinstance(spec, (AddSpec, ConcatSpec)) and n_in < 2:
                raise ValueError(f"merge node {nid} has {n_in} inputs")
            if isinstance(spec, CloneSpec) and n_out < 2:
                raise ValueError(f"clone node {nid} has {n_out} outputs")
            if not isinstance(spec, (CloneSpec, InputSpec)) and n_out > 1:
                raise ValueError(f"non-clone node {nid} fans out ({n_out})")

    # summary used by benchmarks
    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for spec in self.nodes.values():
            key = type(spec).__name__.replace("Spec", "").lower()
            c[key] = c.get(key, 0) + 1
        return c


@dataclasses.dataclass(frozen=True)
class RinnConfig:
    """Tunables mirroring the paper's §III.C sweep axes."""

    family: str = "conv"          # "conv" | "dense"
    n_backbone: int = 6           # conv (or dense) stack depth = complexity
    image_size: int = 8           # x in Reshape(x, x, ·) — paper uses 9..36^(1/2)
    channels: int = 1             # reshape channel count (paper: 1 or 2)
    filters: int = 2              # Conv2D filter count (§III.C.6)
    kernel: int = 3               # Conv2D kernel size (§III.C.5)
    dense_units: int = 16         # dense-family layer width
    pattern: str = "density"      # connection strategy (§III.C.4)
    density: float = 0.25         # extra-edge probability
    merge_op: str = "add"         # "add" | "concat" | "mixed"
    seed: int = 0

    def __post_init__(self):
        if self.family not in ("conv", "dense"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.pattern not in PATTERNS:
            raise ValueError(f"pattern must be one of {PATTERNS}")
        if self.merge_op not in ("add", "concat", "mixed"):
            raise ValueError("merge_op must be add|concat|mixed")


def _skip_pairs(cfg: RinnConfig, rng: np.random.Generator, n: int):
    """Extra (i → j) backbone skip edges, j > i + 1, per connection pattern."""
    pairs = []
    for i in range(n):
        for j in range(i + 2, n):
            span = j - i
            if cfg.pattern == "density":
                ok = rng.random() < cfg.density
            elif cfg.pattern == "short_skip":
                ok = span == 2 and rng.random() < max(cfg.density, 0.5)
            elif cfg.pattern == "long_skip":
                ok = span >= max(2, n // 2) and rng.random() < max(cfg.density, 0.5)
            else:  # ends_only: first few -> last few, no intermediate wiring
                f = max(1, n // 4)
                ok = i < f and j >= n - f and rng.random() < max(cfg.density, 0.5)
            if ok:
                pairs.append((i, j))
    return pairs


def generate_rinn(cfg: RinnConfig) -> RinnGraph:
    rng = np.random.default_rng(cfg.seed)
    nodes: Dict[str, LayerSpec] = {}
    edges: List[Tuple[str, str]] = []

    def add_node(spec: LayerSpec) -> str:
        nodes[spec.name] = spec
        return spec.name

    # ---------------- stem (paper: input 16 -> dense -> reshape) ----------
    inp = add_node(InputSpec(name="input", shape=(16,)))
    if cfg.family == "conv":
        x = cfg.image_size
        stem = add_node(DenseSpec(name="dense_in",
                                  units=x * x * cfg.channels))
        edges.append((inp, stem))
        rs = add_node(ReshapeSpec(name="reshape", target=(x, x, cfg.channels)))
        edges.append((stem, rs))
        prev = rs
        make_backbone = lambda i: Conv2DSpec(
            name=f"conv{i}", filters=cfg.filters, kernel=cfg.kernel)
    else:
        stem = add_node(DenseSpec(name="dense_in", units=cfg.dense_units))
        edges.append((inp, stem))
        prev = stem

        def make_backbone(i):
            act = ["relu", "sigmoid", None][int(rng.integers(0, 3))]
            return DenseSpec(name=f"dense{i}", units=cfg.dense_units,
                             activation=act)

    # ---------------- backbone with random interconnections ----------------
    n = cfg.n_backbone
    skips = _skip_pairs(cfg, rng, n)
    # wire sources: backbone node j receives [prev_chain] + [skip sources]
    srcs_of: List[List[str]] = [[] for _ in range(n)]
    backbone_ids: List[str] = []
    # virtual names first; actual merge/clone nodes materialized below
    for j in range(n):
        backbone_ids.append(f"__bb{j}__")
    chain_src = [prev] + backbone_ids[:-1]
    for j in range(n):
        srcs_of[j].append(chain_src[j])
    for (i, j) in skips:
        srcs_of[j].append(backbone_ids[i])

    # consumers per source (to materialize clones)
    consumers: Dict[str, List[int]] = {}
    for j in range(n):
        for s in srcs_of[j]:
            consumers.setdefault(s, []).append(j)

    # conv family add/concat must match shapes; 'concat' widens channels, which
    # Conv2D accepts.  For the dense family both work on flat vectors of equal
    # width (enforced: same units).
    def merge_spec(name: str) -> LayerSpec:
        op = cfg.merge_op
        if op == "mixed":
            op = "add" if rng.random() < 0.5 else "concat"
        return AddSpec(name=name) if op == "add" else ConcatSpec(name=name)

    # materialize: clones for fan-out sources (incl. backbone + stem),
    # merges for fan-in stages, then the backbone layer itself.
    realized: Dict[str, str] = {}  # virtual/real source -> stream output id

    def source_out(s: str, j: int) -> str:
        """Edge-source feeding backbone stage j from source s (clone-aware)."""
        outs = consumers.get(s, [])
        real = realized.get(s, s)
        if len(outs) > 1:
            clone_id = f"clone_{real}"
            if clone_id not in nodes:
                add_node(CloneSpec(name=clone_id, n_copies=len(outs)))
                edges.append((real, clone_id))
            return clone_id
        return real

    for j in range(n):
        spec = make_backbone(j)
        srcs = [source_out(s, j) for s in srcs_of[j]]
        nid = add_node(spec)
        if len(srcs) == 1:
            edges.append((srcs[0], nid))
        else:
            m = add_node(merge_spec(f"merge{j}"))
            for s in srcs:
                edges.append((s, m))
            edges.append((m, nid))
        realized[backbone_ids[j]] = nid

    last = realized[backbone_ids[-1]]

    # ---------------- head (paper: flatten -> dense(5, sigmoid)) ----------
    if cfg.family == "conv":
        fl = add_node(FlattenSpec(name="flatten"))
        edges.append((last, fl))
        last = fl
    head = add_node(DenseSpec(name="dense_out", units=5, activation="sigmoid"))
    edges.append((last, head))

    g = RinnGraph(nodes=nodes, edges=edges)
    g.validate()
    return g
