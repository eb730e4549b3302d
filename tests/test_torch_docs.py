"""The documentation contract of the port, held against the reference's
(``tests/test_docs.py``).

- Every class and function in ``__all__`` of the eleven counterpart
  modules has a real docstring, by the reference's rule.
- Every name in ``__all__`` of the reference's eleven public modules and of
  ``repro.roofline`` is in its counterpart's ``__all__``, or in ``NO_TWIN``
  with the reason it has none.
- Each page of ``docs/torch/`` has one block for each block of its
  reference page, and its blocks run verbatim, in order, in one namespace,
  with ``DEVICE = "cpu"``. The reference page's blocks run in this process
  as ``tests/test_docs.py`` runs them, and ``HELD`` names, page by page,
  each variable the two namespaces must agree on and how:
  deterministic schedulers (LBP, RBP) give equal round counts and
  converged flags and beliefs within ``BELIEF_TOL``; served records agree
  by rid (routed and threaded runs interleave in both packages, so their
  order is not compared), statuses included; max-product assignments and
  the max kernel's outputs are bitwise; RnBP and rlx draw from a
  ``torch.Generator``, not threefry, so their runs are held only at the
  fixed point, within ``FIXED_POINT_TOL``.
- ``docs/torch/sharding.md`` runs in a child process, where its first
  block makes a gloo world of one. The reference's sharded and banded
  paths fail on the installed jax (ROADMAP queue 3, facts), so the page is
  held against the reference's one-device runs of the same graph.
- A batched backend registered by name runs through
  ``BPConfig(batch_backend=name).run_many`` in both packages.
- The pages' relative links resolve, and README links every page.

The demo entries the pages register (``narrowest-first``, ``coldest``,
``two_then_rest``, ``demo_loop``, ``damped_ref``) go into process-global
registries of both packages: each page's run snapshots and restores them.
"""

import importlib
import inspect
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
DOCS = REPO / "docs"
TORCH_DOCS = DOCS / "torch"

PUBLIC_MODULES = ["repro_torch.core", "repro_torch.core.engine",
                  "repro_torch.core.serving", "repro_torch.core.batch",
                  "repro_torch.core.runner", "repro_torch.dist",
                  "repro_torch.serve", "repro_torch.pgm.datasets",
                  "repro_torch.kernels.ops",
                  "repro_torch.kernels.triton_update",
                  "repro_torch.roofline.kernel_model"]

#: (reference module, name) -> why the port has no counterpart
NO_TWIN = {
    ("repro.core", "batch_keys"):
        "splits a JAX key; batch_generators gives one torch.Generator a "
        "graph",
    ("repro.core.batch", "batch_keys"):
        "splits a JAX key; batch_generators gives one torch.Generator a "
        "graph",
    ("repro.kernels.triton_update", "pick_block_edges_gpu"):
        "the port pads nothing and has no block size to pick: plan_e",
    ("repro.kernels.triton_update", "autotune_blk_e"):
        "the port pads nothing and has no block size to tune: plan_e",
    ("repro.kernels.triton_update", "next_pow2"):
        "the port pads nothing: plan_e takes S as it is",
    ("repro.roofline.kernel_model", "gpu_padded_shape"):
        "the port pads nothing: plan_e takes S as it is",
    ("repro.roofline", "gpu_padded_shape"):
        "the port pads nothing: plan_e takes S as it is",
    ("repro.roofline", "analyze_compiled"):
        "reads XLA's compiled cost analysis; roofline.op_cost counts the "
        "ops, with no XLA",
    ("repro.roofline", "jaxpr_cost"):
        "walks a jaxpr; roofline.op_cost counts torch ops, with no XLA",
}

#: reference page -> its blocks' count, the port page's too
PAGES = {"engine.md": 4, "schedulers.md": 2, "serving.md": 4,
         "admission.md": 6, "router.md": 3, "workloads.md": 4,
         "kernels.md": 4, "sharding.md": 3}

BELIEF_TOL = 1e-4            # ROADMAP's rules of the port: backends, 1e-4
FIXED_POINT_TOL = 5e-3       # stochastic schedulers, at the fixed point
#: LBP's eps on each page that runs it. A near-tie: one package finishes
#: a graph a round before the other, its last residual within NEAR_TIE of
#: eps below it. At eps = 1e-5 a residual is the difference of two float32
#: log-messages of magnitude ~1, whose ulp is 1.2 % of eps, and the two
#: packages' residuals differ by a few ulps: float32 noise on both sides
#: (tests/test_torch_serving.py::
#: test_eps_1e5_rounds_and_residuals_are_float32_noise, where
#: ising_grid(8, 1.5, seed=1) takes 16 rounds here and 17 there).
EPS = {"serving.md": 1e-5, "admission.md": 1e-5, "router.md": 1e-5,
       "workloads.md": 1e-4}
NEAR_TIE = 0.1
#: page -> the results that take a near-tie, counted: admission's
#: ising_grid(8, 1.5, seed=1) under fifo and residual admission (the
#: reference's residual 17 rounds), router's ising_grid(6, 1.5, seed=7)
#: at rid 9 of the stealing run (the reference's 13 rounds, its residual
#: 9.3e-6)
NEAR_TIES = {"admission.md": 2, "router.md": 1}

#: page -> (expression, how): each evaluated in both pages' namespaces
HELD = {
    "engine.md": [("res", "fixed_point"), ("chunked", "fixed_point"),
                  ("report.results", "fixed_points"),
                  ("report.stats.evacuated", "equal")],
    "schedulers.md": [("res", "fixed_point")],
    "serving.md": [("legacy.results", "results"), ("rep.results", "results"),
                   ("evac_only.results", "results"),
                   ("rep.stats.useful_sweeps", "equal"),
                   ("rep2.records", "records"), ("sorted(seen)", "equal")],
    "admission.md": [("fifo.results", "results"),
                     ("resid.results", "results"),
                     ("fifo_b.records", "records"),
                     ("wind_b.records", "records"),
                     ("wind_b.stats.admission_widths[0]", "equal"),
                     ("dl.records", "records"),
                     ("dl.stats.evictions", "equal"),
                     ("rep.records", "records"), ("rep2.records", "records")],
    "router.md": [("rep.records", "records"), ("rep.stats.routed", "equal"),
                  ("solo.records", "records"), ("rep2.records", "records"),
                  ("rep3.records", "records"), ("rep3.stats.routed", "equal")],
    "workloads.md": [("decoded", "bitwise"), ("labels", "bitwise"),
                     ("res", "result"), ("rep.records", "records")],
    "kernels.md": [("new", "bitwise"), ("resid", "bitwise"),
                   ("res_t", "result"), ("res_r", "result"),
                   ("measured.bytes", "equal"), ("model.bytes", "equal"),
                   ("model.flops", "equal")],
}


def _code_blocks(md_path):
    return re.findall(r"```python\n(.*?)```", md_path.read_text(),
                      flags=re.DOTALL)


def _public_objects(modname):
    mod = importlib.import_module(modname)
    assert hasattr(mod, "__all__"), f"{modname} must declare __all__"
    for name in mod.__all__:
        yield name, getattr(mod, name)


@pytest.mark.parametrize("modname", PUBLIC_MODULES)
def test_public_symbols_have_real_docstrings(modname):
    # the reference's rule (tests/test_docs.py), on the port's modules
    missing = []
    for name, obj in _public_objects(modname):
        if not (inspect.isclass(obj) or inspect.isroutine(obj)):
            continue
        doc = inspect.getdoc(obj) or ""
        if len(doc) < 40 or doc.startswith(f"{name}("):
            missing.append(name)
    assert not missing, f"{modname}: undocumented public symbols: {missing}"


@pytest.mark.parametrize("modname", [m.replace("repro_torch", "repro", 1)
                                     for m in PUBLIC_MODULES]
                         + ["repro.roofline"])
def test_every_reference_name_has_a_twin_or_a_reason(modname):
    ref = importlib.import_module(modname)
    port = importlib.import_module(modname.replace("repro", "repro_torch", 1))
    missing = [n for n in ref.__all__
               if n not in port.__all__ and (modname, n) not in NO_TWIN]
    assert not missing, f"{modname}: no counterpart and no reason: {missing}"
    # a reason names a name that really has no twin, and one the
    # reference still exports
    stale = [n for (m, n) in NO_TWIN
             if m == modname and (n in port.__all__ or n not in ref.__all__)]
    assert not stale, f"{modname}: NO_TWIN is stale for {stale}"
    for n in port.__all__:
        getattr(port, n)                    # every exported name resolves


def _registries(pkg):
    core = importlib.import_module(f"{pkg}.core")
    serving = importlib.import_module(f"{pkg}.core.serving")
    ops = importlib.import_module(f"{pkg}.kernels.ops")
    datasets = importlib.import_module(f"{pkg}.pgm.datasets")
    routing = importlib.import_module(f"{pkg}.serve.routing")
    return (core.SCHEDULERS, ops.UPDATE_BACKENDS, ops.BATCH_UPDATE_BACKENDS,
            serving.ADMISSION_POLICIES, routing.ROUTING_POLICIES,
            datasets.WORKLOADS)


def _run_page(md_path, pkg, ns):
    """Every block of ``md_path`` in ``ns``, in order, the registries of
    ``pkg`` restored after."""
    registries = _registries(pkg)
    snapshots = [dict(r) for r in registries]
    try:
        for i, block in enumerate(_code_blocks(md_path)):
            try:
                exec(compile(block, f"{md_path.relative_to(REPO)}[block {i}]",
                             "exec"), ns)
            except Exception as e:     # pragma: no cover - failure reporting
                pytest.fail(f"{md_path.name} ({pkg}) block {i} failed: "
                            f"{e!r}\n{block}")
    finally:
        for reg, snap in zip(registries, snapshots):
            reg.clear()
            reg.update(snap)
    return ns


def _probs(res):
    return np.exp(np.asarray(res.beliefs, dtype=np.float64))


def _near_tie(got, want, eps):
    """One package finished a round before the other with its last
    residual just under ``eps``."""
    first = got if int(got.rounds) < int(want.rounds) else want
    r = float(first.max_residual)
    return (eps is not None and abs(int(got.rounds) - int(want.rounds)) == 1
            and (1 - NEAR_TIE) * eps <= r < eps)


def _hold(what, how, got, want, eps=None, ties=None):
    """Raise unless the port's ``got`` agrees with the reference's ``want``
    as ``how`` says; a near-tie at ``eps`` is appended to ``ties``."""
    if how == "equal":
        assert got == want, f"{what}: {got} != {want}"
    elif how == "bitwise":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    elif how == "result":
        if int(got.rounds) != int(want.rounds) and _near_tie(got, want, eps):
            ties.append(what)
        else:
            assert int(got.rounds) == int(want.rounds), \
                f"{what}: rounds {int(got.rounds)} != {int(want.rounds)}"
        assert bool(got.converged) == bool(want.converged), what
        np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                                   atol=BELIEF_TOL, err_msg=what)
    elif how == "fixed_point":
        assert bool(got.converged) and bool(want.converged), \
            f"{what}: not both at the fixed point"
        np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                                   atol=FIXED_POINT_TOL, err_msg=what)
    elif how in ("results", "fixed_points"):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(f"{what}[{i}]", how[:-1], g, w, eps, ties)
    elif how == "records":
        mine = {r.rid: r for r in got}
        theirs = {r.rid: r for r in want}
        assert sorted(mine) == sorted(theirs), what
        for rid, r in theirs.items():
            assert mine[rid].status == r.status, \
                f"{what} rid {rid}: {mine[rid].status} != {r.status}"
            _hold(f"{what} rid {rid}", "result", mine[rid].result, r.result,
                  eps, ties)
    else:                                   # pragma: no cover
        raise ValueError(how)


@pytest.mark.parametrize("md", sorted(HELD))
def test_torch_page_blocks_execute_and_hold_against_the_reference(md):
    ref_blocks, port_blocks = (_code_blocks(DOCS / md),
                               _code_blocks(TORCH_DOCS / md))
    assert len(ref_blocks) == PAGES[md], f"docs/{md} changed its blocks"
    assert len(port_blocks) == PAGES[md], \
        f"docs/torch/{md} needs one block for each of docs/{md}'s"
    theirs = _run_page(DOCS / md, "repro", {})
    mine = _run_page(TORCH_DOCS / md, "repro_torch", {"DEVICE": "cpu"})
    ties = []
    for expr, how in HELD[md]:
        _hold(f"{md}: {expr}", how, eval(expr, mine), eval(expr, theirs),
              EPS.get(md), ties)
    assert len(ties) == NEAR_TIES.get(md, 0), ties


SHARDING_CHILD = """
import json, re, sys
import numpy as np
import torch
torch.set_num_threads(1)
text = open(sys.argv[1]).read()
ns = {"DEVICE": "cpu"}
for i, block in enumerate(re.findall(r"```python\\n(.*?)```", text,
                                     flags=re.DOTALL)):
    exec(compile(block, f"docs/torch/sharding.md[block {i}]", "exec"), ns)
np.savez(sys.argv[2], beliefs=ns["res"].beliefs.numpy(),
         logm=ns["logm"].numpy())
print(json.dumps({"blocks": i + 1, "converged": bool(ns["res"].converged),
                  "rounds": int(ns["rounds"]), "done": bool(ns["done"]),
                  "world": ns["dist"].is_initialized()}))
"""


def test_torch_sharding_page_runs_in_a_world_of_one(tmp_path):
    """``docs/torch/sharding.md`` in a child process (its first block
    makes a gloo world of one, its last destroys it): RnBP on the sharded
    backend at the fixed point of the reference's one-device RnBP, within
    ``FIXED_POINT_TOL``; banded LBP round-exact against the reference's
    one-device LBP, its messages within ``BELIEF_TOL``."""
    from repro.core import BPConfig as JConfig
    from repro.core import BPEngine as JEngine
    from repro.pgm import ising_grid as j_ising_grid
    assert len(_code_blocks(DOCS / "sharding.md")) == PAGES["sharding.md"]
    assert len(_code_blocks(TORCH_DOCS / "sharding.md")) == \
        PAGES["sharding.md"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    child = subprocess.Popen(
        [sys.executable, "-c", SHARDING_CHILD,
         str(TORCH_DOCS / "sharding.md"), str(tmp_path / "out.npz")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # the reference's one-device runs of the page's graph, meanwhile
    pgm = j_ising_grid(16, 2.0, seed=0)
    rnbp = JEngine(JConfig(scheduler="rnbp")).run(pgm, jax.random.key(0))
    lbp = JEngine(JConfig(scheduler="lbp", eps=1e-5, max_rounds=6000)).run(
        pgm, jax.random.key(0))
    out, err = child.communicate(timeout=240)
    assert child.returncode == 0, err[-4000:]
    got = json.loads(out.strip().splitlines()[-1])
    arrays = np.load(tmp_path / "out.npz")
    assert got["blocks"] == PAGES["sharding.md"] and not got["world"]
    assert got["converged"] and bool(rnbp.converged)
    np.testing.assert_allclose(np.exp(arrays["beliefs"]), _probs(rnbp),
                               rtol=0, atol=FIXED_POINT_TOL)
    assert got["done"] and bool(lbp.converged)
    assert got["rounds"] == int(lbp.rounds)
    np.testing.assert_allclose(np.exp(arrays["logm"]),
                               np.exp(np.asarray(lbp.logm, np.float64)),
                               rtol=0, atol=BELIEF_TOL)


def test_registered_batched_backend_runs_in_both_packages():
    """``register_update_backend(name, batched=True)`` and then
    ``BPConfig(batch_backend=name)``: the reference's vmapped ``ref_update``
    and the port's fold of it over the bucket's union give equal rounds
    and beliefs within ``BELIEF_TOL``; the name lists beside the built-in
    two, and the registries are restored after."""
    from repro.core import BPConfig as JConfig
    from repro.core import BPEngine as JEngine
    from repro.core import messages as JM
    from repro.kernels import ops as JO
    from repro.pgm import ising_grid as j_ising_grid
    from repro_torch.core import BPConfig, BPEngine
    from repro_torch.core import messages as TM
    from repro_torch.kernels import ops as TO
    from repro_torch.pgm import ising_grid
    name = "folded_ref_demo"
    j_snap, t_snap = (dict(JO.BATCH_UPDATE_BACKENDS),
                      dict(TO.BATCH_UPDATE_BACKENDS))
    try:
        JO.register_update_backend(name, batched=True)(
            lambda: jax.vmap(JM.ref_update))

        @TO.register_update_backend(name, batched=True)
        def _fold():
            return lambda batch, logm: batch.folded_update(TM.ref_update,
                                                           logm)

        assert TO.list_backends(batched=True) == \
            JO.list_backends(batched=True) == ["folded_ref_demo", "pallas",
                                               "triton"]
        sizes = [(5, 0), (6, 1), (5, 2), (7, 3)]
        cfg = dict(scheduler="lbp", eps=1e-4, max_rounds=300,
                   batch_backend=name)
        theirs = JEngine(JConfig(**cfg)).run_many(
            [j_ising_grid(n, 2.0, seed=s) for n, s in sizes],
            jax.random.key(0))
        mine = BPEngine(BPConfig(**cfg), device="cpu").run_many(
            [ising_grid(n, 2.0, seed=s, device="cpu") for n, s in sizes], 0)
        _hold("run_many", "results", mine, theirs)
    finally:
        for reg, snap in ((JO.BATCH_UPDATE_BACKENDS, j_snap),
                          (TO.BATCH_UPDATE_BACKENDS, t_snap)):
            reg.clear()
            reg.update(snap)


@pytest.mark.parametrize("md", sorted(PAGES))
def test_torch_page_links_resolve(md):
    path = TORCH_DOCS / md
    broken = [t for t in re.findall(r"\]\(([^)#]+?)(?:#[^)]*)?\)",
                                    path.read_text())
              if not t.startswith(("http://", "https://", "mailto:"))
              and not (path.parent / t).resolve().exists()]
    assert not broken, f"docs/torch/{md}: broken relative links: {broken}"


def test_readme_links_every_torch_page():
    readme = (REPO / "README.md").read_text()
    pages = sorted(p.name for p in TORCH_DOCS.glob("*.md"))
    assert pages == sorted(PAGES)
    missing = [f"docs/torch/{p}" for p in pages
               if f"docs/torch/{p}" not in readme]
    assert not missing, f"README.md does not link: {missing}"
