"""Parity of the PyTorch port's RINN front end with the JAX package.

Graph generation (identical node and edge lists), the layers' ``apply`` and
the profiled ``forward`` (rtol/atol 1e-5 in fp32, every decoded profile
label), ``forward_batch``, the routing-DAG projection, the port of
``test_paper_flow_end_to_end`` on the CPU, the no-fallback device rule and
the import rule (the port imports neither ``jax`` nor ``repro``).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.rinn as J
import repro_torch.rinn as T
from repro.core.policies import plan_routing as j_plan_routing
from repro_torch.core import ProfileCollector
from repro_torch.core.policies import plan_routing as t_plan_routing

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def both_graphs(**cfg):
    return J.generate_rinn(J.RinnConfig(**cfg)), T.generate_rinn(
        T.RinnConfig(**cfg))


def graph_key(g):
    return ([(nid, type(s).__name__, dataclasses.asdict(s))
             for nid, s in g.nodes.items()], list(g.edges))


def jax_params(g, seed):
    return jax.tree_util.tree_map(
        np.asarray, J.init_params(g, jax.random.PRNGKey(seed)))


# --------------------------------------------------------------------- #
# graph generation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["conv", "dense"])
@pytest.mark.parametrize("pattern", list(J.PATTERNS))
@pytest.mark.parametrize("merge_op", ["add", "concat", "mixed"])
def test_generate_rinn_identical(family, pattern, merge_op):
    for seed in range(3):
        jg, tg = both_graphs(family=family, pattern=pattern,
                             merge_op=merge_op, n_backbone=7, image_size=6,
                             density=0.4, seed=seed)
        assert graph_key(tg) == graph_key(jg)
        assert tg.topo_order() == jg.topo_order()
        assert tg.shapes() == jg.shapes()
        assert tg.counts() == jg.counts()


def test_timing_profiles_and_patterns_identical():
    assert T.PATTERNS == J.PATTERNS
    assert set(T.BOARDS) == set(J.BOARDS)
    for name in J.BOARDS:
        assert (dataclasses.asdict(T.BOARDS[name])
                == dataclasses.asdict(J.BOARDS[name]))


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
LAYER_CASES = [
    ("DenseSpec", dict(units=6, activation="relu"), [(10,)]),
    ("DenseSpec", dict(units=5, activation="sigmoid"), [(7,)]),
    ("DenseSpec", dict(units=4), [(3,)]),
    ("Conv2DSpec", dict(filters=3, kernel=3), [(6, 5, 2)]),
    ("Conv2DSpec", dict(filters=2, kernel=2), [(5, 6, 3)]),
    ("DepthwiseConv2DSpec", dict(kernel=3), [(6, 6, 4)]),
    ("MaxPool2DSpec", dict(pool=2), [(6, 4, 3)]),
    ("AvgPool2DSpec", dict(pool=2), [(4, 8, 2)]),
    ("AddSpec", {}, [(4, 4, 2)] * 3),
    ("ConcatSpec", {}, [(4, 4, 2), (4, 4, 1)]),
    ("ConcatSpec", {}, [(5,), (3,)]),
    ("ReluSpec", {}, [(9,)]),
    ("SigmoidSpec", {}, [(3, 3, 2)]),
    ("ReshapeSpec", dict(target=(4, 4, 1)), [(16,)]),
    ("FlattenSpec", {}, [(3, 2, 2)]),
    ("CloneSpec", {}, [(3, 3, 1)]),
]


@pytest.mark.parametrize("cls,kw,in_shapes", LAYER_CASES)
def test_layer_apply_matches(cls, kw, in_shapes):
    jspec = getattr(J, cls)(name="n", **kw)
    tspec = getattr(T, cls)(name="n", **kw)
    timing = J.ZCU102.with_(reuse_factor=4)
    assert tspec.out_shape(in_shapes) == jspec.out_shape(in_shapes)
    for method in ("fill_beats", "ii_cycles"):
        assert (getattr(tspec, method)(in_shapes, timing)
                == getattr(jspec, method)(in_shapes, timing))
    assert tspec.burst() == jspec.burst()
    assert tspec.profiled == jspec.profiled

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in in_shapes]
    params = jax.tree_util.tree_map(
        np.asarray, jspec.init(jax.random.PRNGKey(1), in_shapes))
    t_init = tspec.init(torch.Generator().manual_seed(1), in_shapes)
    assert ({k: tuple(v.shape) for k, v in t_init.items()}
            == {k: v.shape for k, v in params.items()})
    want = jspec.apply(params, [jnp.asarray(x) for x in xs])
    got = tspec.apply({k: torch.tensor(v) for k, v in params.items()},
                      [torch.from_numpy(x) for x in xs])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------- #
# forward with the in-band profile stream
# --------------------------------------------------------------------- #
FORWARD_CFGS = [
    dict(n_backbone=5, image_size=6, seed=2, pattern="long_skip",
         density=0.5),
    dict(n_backbone=6, image_size=6, kernel=2, pattern="short_skip",
         merge_op="concat", seed=3),
    dict(n_backbone=6, image_size=4, pattern="ends_only", merge_op="mixed",
         channels=2, seed=5),
    dict(family="dense", n_backbone=6, density=0.5, merge_op="mixed",
         seed=1),
]


@pytest.mark.parametrize("cfg", FORWARD_CFGS)
def test_forward_and_profile_stream_match(cfg):
    jg, tg = both_graphs(**cfg)
    params = jax_params(jg, seed=cfg["seed"])
    x = np.random.default_rng(cfg["seed"]).standard_normal(16).astype(
        np.float32)
    jy, js = J.forward(jg, params, jnp.asarray(x))
    ty, ts = T.forward(tg, T.params_from_numpy(params, device="cpu"),
                       torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert [dataclasses.astuple(lbl) for lbl in ts.schema] == [
        dataclasses.astuple(lbl) for lbl in js.schema]
    assert ts.n_words == js.n_words and ts.n_signals == js.n_signals
    want, got = js.decode(), ProfileCollector().ingest(ts)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)
    # profile off: the same output, no stream
    y_off, s_off = T.forward(tg, T.params_from_numpy(params, device="cpu"),
                             torch.from_numpy(x), profile="off")
    assert s_off is None
    np.testing.assert_allclose(y_off.numpy(), ty.numpy(), rtol=0, atol=0)


def test_forward_batch_matches():
    jg, tg = both_graphs(n_backbone=5, image_size=6, seed=2,
                         pattern="long_skip", density=0.5)
    params = jax_params(jg, seed=0)
    xb = np.random.default_rng(7).standard_normal((3, 16)).astype(np.float32)
    want = J.forward_batch(jg, params, jnp.asarray(xb))
    got = T.forward_batch(tg, T.params_from_numpy(params, device="cpu"),
                          torch.from_numpy(xb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_params_shapes_and_seed():
    jg, tg = both_graphs(n_backbone=6, image_size=6, pattern="density",
                         merge_op="mixed", seed=4)
    want = jax_params(jg, seed=0)
    got = T.init_params(tg, 0, device="cpu")
    assert ({n: {k: tuple(v.shape) for k, v in p.items()}
             for n, p in got.items()}
            == {n: {k: v.shape for k, v in p.items()}
                for n, p in want.items()})
    again = T.init_params(tg, torch.Generator().manual_seed(0),
                          device="cpu")
    for n in got:
        for k in got[n]:
            assert torch.equal(got[n][k], again[n][k])
            assert got[n][k].dtype == torch.float32


def test_to_profiled_dag_and_routing_match():
    jg, tg = both_graphs(n_backbone=7, image_size=6, pattern="density",
                         density=0.5, seed=9)
    jd, td = J.to_profiled_dag(jg), T.to_profiled_dag(tg)
    assert ([dataclasses.astuple(n) for n in td.nodes]
            == [dataclasses.astuple(n) for n in jd.nodes])
    assert list(td.edges) == list(jd.edges)
    jp = j_plan_routing(jd, policy="inline", split_rule="first")
    tp = t_plan_routing(td, policy="inline", split_rule="first")
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    # the forward's stream realizes the inline plan's label order: the plan
    # names words node[i], the stream node/metric
    _, stream = T.forward(tg, T.init_params(tg, 0, device="cpu"),
                          torch.ones(16))

    def node_of(label, sep):
        return "__ph__" if label.startswith("__placeholder") else label.split(
            sep)[0]

    assert ([node_of(lbl.name, "/") for lbl in stream.schema]
            == [node_of(lbl, "[") for lbl in tp.label_order])


# --------------------------------------------------------------------- #
# the paper flow, on the CPU
# --------------------------------------------------------------------- #
def test_paper_flow_end_to_end():
    """RINN generation -> functional profiled run -> streaming cosim."""
    cfg = T.RinnConfig(n_backbone=5, image_size=6, seed=2,
                       pattern="long_skip", density=0.5)
    g = T.generate_rinn(cfg)
    params = T.init_params(g, 0, device="cpu")
    y, stream = T.forward(g, params, torch.ones(16))
    assert y.shape == (5,)

    collector = ProfileCollector()
    decoded = collector.ingest(stream)
    assert len(decoded) == stream.n_signals > 0

    rep = T.compare(g, T.ZCU102, device="cpu")
    assert rep.mean_abs_diff < 3.0
    assert rep.max_abs_diff <= 8
    assert rep.max_depth > 10


# --------------------------------------------------------------------- #
# devices and imports
# --------------------------------------------------------------------- #
ENTRY_POINTS = {
    "init_params": lambda g, s: T.init_params(g, 0),
    "forward": lambda g, s: T.forward(
        g, T.init_params(g, 0, device="cpu"), [1.0] * 16),
    "compare": lambda g, s: T.compare(g, T.ZCU102),
    "cosim_only": lambda g, s: T.cosim_only(g, T.ZCU102),
    "cosim_many": lambda g, s: T.cosim_many([g, g], T.ZCU102),
    "run_sim": lambda g, s: T.run_sim(s),
    "run_sim_single": lambda g, s: T.run_sim_single(s),
    "run_sim_batch": lambda g, s: T.run_sim_batch(s, n=2),
    "run_sim_many": lambda g, s: T.run_sim_many([s, s]),
    "run_with_remediation": lambda g, s: T.run_with_remediation(s),
    "remediate_pair": lambda g, s: T.remediate_pair(s),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_device_needs_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would use it")
    g = T.generate_rinn(T.RinnConfig(n_backbone=4, image_size=4, seed=0))
    sim = T.compile_graph(g, T.ZCU102)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](g, sim)


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.rinn, repro_torch.core\n"
        "import repro_torch.kernels, repro_torch.kernels.ops\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.launch.serve, repro_torch.distributed\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_source_file_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    f"{path.relative_to(ROOT)} imports {name}")
