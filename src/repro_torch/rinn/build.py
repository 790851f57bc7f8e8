"""Functional (PyTorch) realization of a RINN with the in-band profile stream.

The port of :mod:`repro.rinn.build`.  The forward pass traverses the DAG in
topo order.  The profile stream follows the *data edges* exactly as in the
paper: every edge carries (tensor, stream segment); a clone node splits the
stream (first branch carries, others get a placeholder); a merge node
concatenates segments in input order; every profiled node appends its
record.  The positional label order therefore equals
``plan_routing(..., policy="inline", split_rule="first")``.

Parameters are a plain ``{node: {"w": tensor, "b": tensor}}`` dictionary in
the JAX package's layouts; :func:`params_from_numpy` loads the reference's
parameters so that both packages compute the same function.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core import ProfileStream, metrics
from ..core.policies import DagNode, ProfiledDag
from ..device import resolve_device
from .graphgen import RinnGraph
from .layers import InputSpec

RECORD_METRICS = ("act_absmax", "act_rms")
RECORD_SIZE = len(RECORD_METRICS)


def init_params(graph: RinnGraph,
                generator: Union[int, torch.Generator] = 0,
                device=None) -> Dict[str, dict]:
    """Random parameters with the reference's distributions and layouts.

    ``generator`` is a CPU ``torch.Generator`` or an int seed.  Draws happen
    on the CPU in topo order, so a seed gives the same parameters on every
    device; they are then moved to ``device`` (the card by default).  The
    numbers differ from ``jax.random``'s for the same seed.
    """
    dev = resolve_device(device)
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator().manual_seed(int(generator)))
    shapes = graph.shapes()
    params: Dict[str, dict] = {}
    for nid in graph.topo_order():
        spec = graph.nodes[nid]
        ins = [shapes[p] for p in graph.predecessors(nid)]
        p = spec.init(gen, ins) if ins else {}
        if p:
            params[nid] = {k: v.to(dev) for k, v in p.items()}
    return params


def params_from_numpy(params: Dict[str, dict], device=None) -> Dict[str, dict]:
    """The reference's parameters (each leaf as a numpy array, same nesting)
    as the port's tensors on ``device``."""
    dev = resolve_device(device)
    return {nid: {k: torch.tensor(np.asarray(v), device=dev)
                  for k, v in p.items()}
            for nid, p in params.items()}


def forward(
    graph: RinnGraph,
    params: Dict[str, dict],
    x,
    profile: str = "inline",
    profile_dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, Optional[ProfileStream]]:
    """Run the RINN on one example ``x: (16,)``.

    profile: "off" | "inline".  ``x`` may be a tensor (its device is used
    unless ``device`` is given) or array-like (placed on ``device``, the
    card by default).
    """
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(device)
    else:
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=resolve_device(device))
    order = graph.topo_order()
    tensors: Dict[Tuple[str, str], torch.Tensor] = {}
    streams: Dict[Tuple[str, str], ProfileStream] = {}
    profiling = profile != "off"

    out_tensor = None
    out_stream: Optional[ProfileStream] = None
    for nid in order:
        spec = graph.nodes[nid]
        preds = graph.predecessors(nid)
        succs = graph.successors(nid)
        if isinstance(spec, InputSpec):
            y = x
            s = (ProfileStream.create(dtype=profile_dtype, device=x.device)
                 if profiling else None)
        else:
            xs = [tensors.pop((p, nid)) for p in preds]
            y = spec.apply(params.get(nid, {}), xs)
            if profiling:
                s = ProfileStream.merge(*[streams.pop((p, nid)) for p in preds])
                if spec.profiled:
                    s = s.append(f"{nid}/act_absmax", "act_absmax",
                                 metrics.act_absmax(y))
                    s = s.append(f"{nid}/act_rms", "act_rms", metrics.act_rms(y))
            else:
                s = None

        if not succs:
            out_tensor, out_stream = y, s
            continue
        if profiling:
            branches = s.split(len(succs)) if len(succs) > 1 else (s,)
        for i, d in enumerate(succs):
            tensors[(nid, d)] = y
            if profiling:
                streams[(nid, d)] = branches[i]
    return out_tensor, out_stream


def forward_batch(graph, params, xb: torch.Tensor, profile: str = "off"):
    """The single-example forward over a leading batch dimension of ``xb``
    (``torch.func.vmap``; profile off — streams are per-run)."""
    return torch.func.vmap(
        lambda x: forward(graph, params, x, profile="off")[0])(xb)


def to_profiled_dag(graph: RinnGraph) -> ProfiledDag:
    """Project the RINN onto the abstract routing DAG (for plan cross-checks)."""
    nodes = tuple(
        DagNode(nid, RECORD_SIZE if graph.nodes[nid].profiled else 0)
        for nid in graph.nodes
    )
    return ProfiledDag(nodes, tuple(graph.edges))
