"""The port's simulated testbed against the reference on the CPU: the
model pools, the pool manager's transitions, the projections of the OCO
solver, the latency fits, the quality oracle, the query generator, the
simulated ``EdgeNode`` (a slot loop and its profiling), the paper's
baselines, and the ``Coordinator`` and ``ClusterRuntime`` over the
four-node testbed.

Every module here is the same numpy code in both packages, so the
tolerance is 0: floats compare with ``==``, arrays by their bytes, and
each generator's state after the run is equal too.  The one exception
is the PPO identifier in the slot loop, which is float32 torch against
float32 JAX: its probabilities before the first update agree within
1e-6 (``test_torch_ppo.py``'s tolerance for ``act_probs``); after the
first update, params within 2 * lr per Adam step and the probabilities
within 1e-4 once the hidden pre-norm biases are aligned and the
running means less their drift (those biases' updates are rounding
noise; ``test_torch_ppo.py`` and ``test_torch_runtime.py`` state why);
after later updates, the params within 2 * lr per Adam step.  On these
seeds no routing draw falls within the probabilities' difference of a
boundary, so assignments, results and slot metrics are equal in every
slot, after the updates too.  The intra-node schedule
over loads and budgets is in ``test_torch_intra_node.py``."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
from _hyp import given, settings, st

torch = pytest.importorskip("torch")

from repro.cluster import ClusterRuntime as JRuntime  # noqa: E402
from repro.configs import edge_pool as jpool  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro.core import cluster as jcluster  # noqa: E402
from repro.core import intra_node as jintra  # noqa: E402
from repro.core import latency_model as jlat  # noqa: E402
from repro.core import quality_model as jqual  # noqa: E402
from repro.core import workload as jwork  # noqa: E402
from repro.core.coordinator import Coordinator as JCoord  # noqa: E402
from repro.core.identifier import OnlineQueryIdentifier as JIdent  # noqa: E402
from repro.core.inter_node import CapacityFunction as JCap  # noqa: E402
from repro.serving import pool as jmgr  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import ClusterRuntime  # noqa: E402
from repro_torch.configs import edge_pool  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import cluster  # noqa: E402
from repro_torch.core import intra_node  # noqa: E402
from repro_torch.core import latency_model  # noqa: E402
from repro_torch.core import ppo  # noqa: E402
from repro_torch.core import quality_model  # noqa: E402
from repro_torch.core import workload  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.identifier import OnlineQueryIdentifier  # noqa: E402
from repro_torch.core.inter_node import CapacityFunction  # noqa: E402
from repro_torch.core.protocols import (QueryRouter,  # noqa: E402
                                        SchedulableNode, SlotScheduler)
from repro_torch.serving import pool as mgr  # noqa: E402


def _same(a, b):
    """Bitwise equality of arrays (dtype, shape and bytes)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _rng_state(rng):
    return rng.bit_generator.state


def _fields(obj):
    return dataclasses.astuple(obj) if dataclasses.is_dataclass(obj) \
        else obj


# ------------------------------------------------------------ model pools


def test_model_specs_match_reference():
    assert list(edge_pool.MODEL_SPECS) == list(jpool.MODEL_SPECS)
    for name, spec in jpool.MODEL_SPECS.items():
        assert dataclasses.asdict(edge_pool.MODEL_SPECS[name]) == \
            dataclasses.asdict(spec)
    assert edge_pool.PAPER_TESTBED == jpool.PAPER_TESTBED
    assert edge_pool._spec("qwen", "mid", 2.5, 0.5) == \
        edge_pool.EdgeModelSpec(**dataclasses.asdict(
            jpool._spec("qwen", "mid", 2.5, 0.5)))


@pytest.mark.parametrize("family", ["llama", "qwen", "falcon", "none"])
def test_pool_for_family_matches_reference(family):
    assert [dataclasses.asdict(s) for s in edge_pool.pool_for_family(family)
            ] == [dataclasses.asdict(s)
                  for s in jpool.pool_for_family(family)]


# ------------------------------------------------------------ pool manager


def _report(rep):
    return (rep.tl_per_gpu, rep.loads, rep.reloads, rep.unloads, rep.max_tl)


# the transition sequences of test_scheduler_core.py's pool-manager tests
# (load, epsilon snap, unload then reload, over-memory boundaries,
# validation errors): (num_gpus, eps, [allocation by (pool index, gpu)])
SEQUENCES = {
    "lifecycle": (1, 0.01, [{(0, 0): 0.3, (1, 0): 0.6},
                            {(0, 0): 0.3, (1, 0): 0.6},
                            {(0, 0): 0.5}]),
    "epsilon-snap": (1, 0.05, [{(0, 0): 0.30}, {(0, 0): 0.33},
                               {(0, 0): 0.40}]),
    "unload-reload": (1, 0.01, [{(0, 0): 0.3}, {}, {(0, 0): 0.3}]),
    "over-memory": (2, 0.01, [{(0, 0): 0.5, (1, 0): 0.5},
                              {(0, 0): 0.5, (1, 0): 0.52},
                              {(0, 0): 0.5, (1, 1): 0.52}]),
    "validation": (1, 0.01, [{(0, 0): 0.7, (1, 0): 0.7},
                             {(2, 0): 0.05}, {(2, 0): 0.5, (0, 0): 0.3},
                             {(2, 0): 0.5, (1, 0): 0.5}]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_pool_manager_matches_reference(name):
    gpus, eps, steps = SEQUENCES[name]
    pool_o = edge_pool.pool_for_family("llama")
    pool_t = jpool.pool_for_family("llama")
    ours = mgr.ModelPoolManager(pool_o, gpus, eps=eps)
    theirs = jmgr.ModelPoolManager(pool_t, gpus, eps=eps)
    outcomes = []
    for step in steps:
        alloc = {(pool_o[i].name, k): r for (i, k), r in step.items()}
        got = []
        for m in (ours, theirs):
            try:
                got.append(("ok", _report(m.apply(dict(alloc)))))
            except AssertionError as e:
                got.append(("error", str(e)))
        assert got[0] == got[1], step
        outcomes.append(got[0][0])
        assert ours.R == theirs.R
        for k in range(gpus):
            assert ours.deployed(k) == theirs.deployed(k)
    if name in ("over-memory", "validation"):
        assert "error" in outcomes
    if name != "validation":
        assert "ok" in outcomes


def test_reconfig_report_max_tl():
    assert mgr.ReconfigReport([], [], [], []).max_tl == 0.0
    assert mgr.ReconfigReport([1.5, 3.0], [], [], []).max_tl == \
        jmgr.ReconfigReport([1.5, 3.0], [], [], []).max_tl == 3.0


# ------------------------------------------------------------ projections


@given(st.lists(st.floats(-5, 5), min_size=1, max_size=12),
       st.floats(0.1, 3.0))
@settings(max_examples=60, deadline=None)
def test_capped_simplex_projection_matches_reference(v, cap):
    v = np.asarray(v)
    assert _same(intra_node._project_capped_simplex(v, cap),
                 jintra._project_capped_simplex(v, cap))


@given(st.integers(1, 6), st.integers(0, 10 ** 6))
@settings(max_examples=40, deadline=None)
def test_R_projection_matches_reference(n, seed):
    rng = np.random.default_rng(seed)
    rmin = rng.uniform(0.02, 0.9 / n, n)
    R = rng.uniform(-1, 2, n)
    assert _same(intra_node._project_R(R, rmin, 1.0),
                 jintra._project_R(R, rmin, 1.0))


# ------------------------------------------------------------ latency fits


@pytest.mark.parametrize("name", list(jpool.MODEL_SPECS))
def test_latency_fits_match_reference(name):
    spec_o, spec_t = edge_pool.MODEL_SPECS[name], jpool.MODEL_SPECS[name]
    fits_o, rmse_o = latency_model.fit_latency_models(
        latency_model.LatencyOracle(seed=3), spec_o, seed=2)
    fits_t, rmse_t = jlat.fit_latency_models(jlat.LatencyOracle(seed=3),
                                             spec_t, seed=2)
    assert rmse_o == rmse_t and list(fits_o) == list(fits_t)
    for form, fit in fits_t.items():
        mine = fits_o[form]
        assert (mine.form, mine.rmse, mine.q_scale, mine.delta_t) == \
            (fit.form, fit.rmse, fit.q_scale, fit.delta_t)
        assert _same(mine.weights, fit.weights), form
        q = np.array([1.0, 40.0, 300.0])
        assert _same(mine.predict(q, 0.6), fit.predict(q, 0.6))
        assert mine.predict(17, 0.5) == fit.predict(17, 0.5)
    quad_o = latency_model.fit_quadratic(latency_model.LatencyOracle(seed=4),
                                         spec_o, seed=5)
    quad_t = jlat.fit_quadratic(jlat.LatencyOracle(seed=4), spec_t, seed=5)
    assert _same(quad_o.weights, quad_t.weights) and \
        quad_o.rmse == quad_t.rmse


def test_latency_oracle_matches_reference():
    spec_o, spec_t = edge_pool.MODEL_SPECS["qwen-7b"], \
        jpool.MODEL_SPECS["qwen-7b"]
    ours, theirs = latency_model.LatencyOracle(seed=9), \
        jlat.LatencyOracle(seed=9)
    for q, R, noisy in ((5, 0.4, True), (np.arange(1, 50), 0.7, True),
                        (np.arange(1, 9), np.linspace(0.3, 1, 8), False),
                        (200, 1.0, True)):
        assert _same(ours.latency(spec_o, q, R, noisy),
                     theirs.latency(spec_t, q, R, noisy))
    assert _rng_state(ours._rng) == _rng_state(theirs._rng)
    for form in ("linear", "quadratic", "exponential", "cubic"):
        assert _same(latency_model._features([1.0, 2.0], 0.5, form),
                     jlat._features([1.0, 2.0], 0.5, form))
    with pytest.raises(ValueError):
        latency_model._features([1.0], 0.5, "quartic")


# ------------------------------------------------------------ quality oracle


def test_quality_oracle_draws_match_reference():
    w = np.random.default_rng(0).random((4, 6))
    ours = quality_model.QualityOracle(w, seed=5)
    theirs = jqual.QualityOracle(w, seed=5)
    specs = list(jpool.MODEL_SPECS)
    for i in range(60):
        name, d, n = specs[i % len(specs)], i % 6, i % 4
        assert ours.match(d, n) == theirs.match(d, n)
        assert ours.best_node(d) == theirs.best_node(d)
        assert ours.realized(edge_pool.MODEL_SPECS[name], d, n) == \
            theirs.realized(jpool.MODEL_SPECS[name], d, n)
    pool_o, pool_t = edge_pool.pool_for_family("falcon"), \
        jpool.pool_for_family("falcon")
    assert ours.open_book(pool_o[2], 1, 16) == \
        theirs.open_book(pool_t[2], 1, 16)
    assert quality_model.static_open_book_quality(ours, pool_o, 3) == \
        jqual.static_open_book_quality(theirs, pool_t, 3)
    assert _rng_state(ours._rng) == _rng_state(theirs._rng)


# ------------------------------------------------------------ workloads


def _queries(qs):
    return [(q.domain, q.embedding.dtype.str, q.embedding.tobytes(), q.qid,
             q.question, q.reference) for q in qs]


def test_query_generator_matches_reference():
    ours, theirs = workload.QueryGenerator(seed=1), jwork.QueryGenerator(
        seed=1)
    assert _same(ours.prototypes, theirs.prototypes)
    assert _queries(ours.sample(40)) == _queries(theirs.sample(40))
    p = np.random.default_rng(3).dirichlet(np.full(6, 2.0))
    got = ours.sample(25, p)
    assert _queries(got) == _queries(theirs.sample(25, p))
    assert all(q.embedding.dtype == np.float32 for q in got)
    for a, b in zip(ours.dirichlet_slots(3, 30, alpha=0.5),
                    theirs.dirichlet_slots(3, 30, alpha=0.5)):
        assert _queries(a) == _queries(b)
    assert _queries(ours.skewed(20, 2, 0.7)) == \
        _queries(theirs.skewed(20, 2, 0.7))
    assert ours._qid == theirs._qid == 40 + 25 + 90 + 20
    assert _rng_state(ours._rng) == _rng_state(theirs._rng)


# ------------------------------------------------------------ edge nodes


@pytest.fixture(scope="module")
def testbeds():
    """(port testbed, reference testbed), each (nodes, qual, w)."""
    return cluster.make_paper_testbed(seed=0), jcluster.make_paper_testbed(
        seed=0)


def test_paper_testbed_matches_reference(testbeds):
    (nodes_o, qual_o, w_o), (nodes_t, qual_t, w_t) = testbeds
    assert _same(w_o, w_t) and _same(qual_o.w, qual_t.w)
    assert _rng_state(qual_o._rng) == _rng_state(qual_t._rng)
    assert len(nodes_o) == len(edge_pool.PAPER_TESTBED) == 4
    for a, b in zip(nodes_o, nodes_t):
        assert (a.node_id, a.family, a.num_gpus, a.search_time) == \
            (b.node_id, b.family, b.num_gpus, b.search_time)
        assert [s.name for s in a.pool] == [s.name for s in b.pool]
        assert a.Q_mn == b.Q_mn
        assert list(a.predictors) == list(b.predictors)
        for name, fit in b.predictors.items():
            assert _same(a.predictors[name].weights, fit.weights)
            assert a.predictors[name].rmse == fit.rmse
        assert _rng_state(a._rng) == _rng_state(b._rng)
        assert _rng_state(a.lat._rng) == _rng_state(b.lat._rng)
        assert isinstance(a, SchedulableNode)


@pytest.mark.parametrize("n,w", [(0, [1.0]), (7, [0.0, 0.0]),
                                 (10, [0.2, 0.5, 0.3]),
                                 (13, [1 / 3, 1 / 3, 1 / 3]),
                                 (120, [0.15, -0.1, 0.85, 0.0]),
                                 (5, [0.5, 0.5, 0.0, 1e-13])])
def test_apportion_matches_reference(n, w):
    got = cluster._apportion(n, np.asarray(w))
    assert _same(got, jcluster._apportion(n, np.asarray(w)))
    assert got.sum() in (0, n)


def _results(res):
    return [dataclasses.astuple(r) for r in res]


@pytest.mark.parametrize("node_id", [0, 3], ids=["1-gpu", "2-gpu"])
def test_process_slot_matches_reference(node_id):
    """Three consecutive slots on one node: every QueryResult and the pool
    manager's state after each (the second and third slots start from
    the first's deployment: reloads, snaps and unloads).  The 2-GPU node
    solves with 40 iterations to keep the test short."""
    sides = []
    for make, gen_cls in ((cluster.make_paper_testbed,
                           workload.QueryGenerator),
                          (jcluster.make_paper_testbed,
                           jwork.QueryGenerator)):
        nodes, qual, _ = make(seed=0)
        node = nodes[node_id]
        if node.num_gpus > 1:
            node.scheduler.iters = 40
        log = []
        gen = gen_cls(seed=1)
        for vol, slo in ((60, 15.0), (150, 15.0), (1500, 4.0)):
            res = node.process_slot(gen.sample(vol), slo)
            log.append((_results(res), copy.deepcopy(node.mgr.R)))
        assert node.process_slot([], 15.0) == []
        log.append((_rng_state(node._rng), _rng_state(node.lat._rng),
                    _rng_state(qual._rng)))
        sides.append(log)
    ours, theirs = sides
    assert ours == theirs
    assert any(r[4] for r in ours[2][0])          # the 4 s slot drops


def test_process_slot_under_fixed_schedulers_matches_reference():
    """A baseline scheduler passed to process_slot, and an empty
    allocation (every query dropped)."""
    sides = []
    for mod_cluster, mod_base, gen_cls in (
            (cluster, baselines, workload.QueryGenerator),
            (jcluster, jbase, jwork.QueryGenerator)):
        nodes, _, _ = mod_cluster.make_paper_testbed(seed=0)
        gen = gen_cls(seed=4)
        log = []
        for kind in ("small", "mid", "mixed1", "mixed2"):
            sched = mod_base.FixedDeploymentScheduler(nodes[2], kind)
            res = nodes[2].process_slot(gen.sample(90), 10.0,
                                        scheduler=sched)
            log.append((_results(res), copy.deepcopy(nodes[2].mgr.R)))

        class Nothing:
            def schedule(self, n, budget):
                return mod_cluster.Allocation()
        log.append(_results(nodes[1].process_slot(gen.sample(5), 10.0,
                                                  scheduler=Nothing())))
        sides.append(log)
    assert sides[0] == sides[1]
    assert all(r[4] for r in sides[0][-1])


def test_profile_matches_reference():
    """profile on a 1-GPU node at levels (5, 10): the capacity function,
    the pool manager restored, and every generator's state after it (the
    shared quality oracle draws in profiling too)."""
    sides = []
    for make in (cluster.make_paper_testbed, jcluster.make_paper_testbed):
        nodes, qual, _ = make(seed=0)
        cap = nodes[1].profile(levels=(5, 10))
        assert nodes[1].capacity is cap
        sides.append(((cap.k, cap.b, cap.levels), nodes[1].mgr.R,
                      _rng_state(nodes[1]._rng),
                      _rng_state(nodes[1].lat._rng), _rng_state(qual._rng),
                      nodes[1].burst_drop_rate(500, 5.0)))
    assert sides[0] == sides[1]
    assert sides[0][0][0] > 0 and sides[0][1] == [{}]


# ------------------------------------------------------------ baselines


def test_random_and_domain_allocators_match_reference():
    e = np.random.default_rng(0).standard_normal((7, 64))
    ours, theirs = baselines.RandomAllocator(4, seed=2), \
        jbase.RandomAllocator(4, seed=2)
    assert _same(ours.identify(e), theirs.identify(e))
    assert ours.feedback(e, np.zeros(7, int), np.ones(7)) is None
    assert ours.maybe_update() is None is theirs.maybe_update()
    assert isinstance(ours, QueryRouter)
    prim = {0: 0, 1: 0, 2: 1, 3: 1, 4: 2, 5: 3}
    doms = [0, 5, 3, 3, 1, 4, 2]
    assert _same(baselines.DomainAllocator(prim, 4).probs_for_domains(doms),
                 jbase.DomainAllocator(prim, 4).probs_for_domains(doms))


def test_oracle_allocator_matches_reference(testbeds):
    (_, qual_o, _), (_, qual_t, _) = testbeds
    doms = [5, 0, 1, 2, 3, 4, 4, 0]
    got = baselines.OracleAllocator(qual_o).probs_for_domains(doms)
    assert _same(got, jbase.OracleAllocator(qual_t).probs_for_domains(doms))
    assert [qual_o.best_node(d) for d in doms] == got.argmax(1).tolist()


def test_linucb_matches_reference():
    rng = np.random.default_rng(1)
    ours, theirs = baselines.LinUCBAllocator(16, 4, seed=2), \
        jbase.LinUCBAllocator(16, 4, seed=2)
    assert isinstance(ours, QueryRouter)
    for _ in range(3):
        e = rng.standard_normal((12, 16)).astype(np.float32)
        p = ours.identify(e)
        assert _same(p, theirs.identify(e))
        a = p.argmax(1)
        r = rng.random(12)
        ours.feedback(e, a, r)
        theirs.feedback(e, a, r)
        assert ours.maybe_update() is None
    for x, y in zip(ours.A + ours.Ainv + ours.b,
                    theirs.A + theirs.Ainv + theirs.b):
        assert _same(x, y)


@pytest.mark.parametrize("kind", ["small", "mid", "mixed1", "mixed2"])
def test_fixed_deployments_match_reference(testbeds, kind):
    (nodes_o, _, _), (nodes_t, _, _) = testbeds
    for a, b in zip(nodes_o, nodes_t):
        got = baselines.FixedDeploymentScheduler(a, kind).schedule(100, 10.0)
        want = jbase.FixedDeploymentScheduler(b, kind).schedule(100, 10.0)
        assert _fields(got) == _fields(want)
        assert got.r_alloc() == want.r_alloc()
    with pytest.raises(ValueError):
        baselines.FixedDeploymentScheduler(nodes_o[0], "huge").schedule(
            10, 1.0)


# ------------------------------------------------------------ slot loop


LR = 3e-4


def _identifiers(dim, n_nodes, threshold):
    theirs = JIdent(dim, n_nodes, update_threshold=threshold)
    ours = OnlineQueryIdentifier(dim, n_nodes, update_threshold=threshold,
                                 device="cpu")
    ours.load_policy(bridge.policy_from_numpy(
        jax.tree_util.tree_map(np.asarray, theirs.params), "cpu"))
    return ours, theirs


def _record(coord, log):
    route, dispatch = coord._route, coord._dispatch

    def routed(probs, slo_s):
        assign, props = route(probs, slo_s)
        log.append(("route", probs.copy(), assign.tolist(), props.tolist()))
        return assign, props

    def dispatched(queries, assign, slo_s):
        res = dispatch(queries, assign, slo_s)
        log.append(("results", _results(res)))
        return res

    coord._route, coord._dispatch = routed, dispatched


def _record_biases(monkeypatch):
    """The hidden pre-norm biases each PPO epoch's train forward sees, in
    both packages."""
    seen = {"ours": [], "theirs": []}
    ours_update, theirs_update = ppo.ppo_update, jppo.ppo_update

    def ours_rec(policy, *args, **kw):
        seen["ours"].append([layer.b.detach().clone().numpy()
                             for layer in policy.layers[:-1]])
        return ours_update(policy, *args, **kw)

    def theirs_rec(params, *args, **kw):
        seen["theirs"].append([np.array(layer["b"])
                               for layer in params["layers"][:-1]])
        return theirs_update(params, *args, **kw)

    monkeypatch.setattr(ppo, "ppo_update", ours_rec)
    monkeypatch.setattr(jppo, "ppo_update", theirs_rec)
    return seen


def _assert_policy_close(policy, jparams, seen, steps, e, full=True):
    """test_torch_ppo.py's tolerances for a policy after updates: params
    within 2 * lr per Adam step; with ``full``, also the running means
    less the drift that the two sides' biases at each epoch predict, and
    the running variances, within allclose(atol 1e-5, rtol 1e-4), and the
    probabilities within 1e-4 with the biases aligned and the means less
    that drift."""
    ours_np = bridge.policy_to_numpy(policy)["layers"]
    for mine, want in zip(ours_np, jparams["layers"]):
        for name in want:
            np.testing.assert_allclose(mine[name], want[name], rtol=0,
                                       atol=2 * LR * steps, err_msg=name)
    if not full:
        return
    aligned = copy.deepcopy(policy)
    for n, (layer, want) in enumerate(zip(aligned.layers[:-1],
                                          jparams["layers"])):
        drift = sum((1 - ppo.BN_MOMENTUM) * ppo.BN_MOMENTUM ** (steps - 1 - c)
                    * (seen["ours"][c][n] - seen["theirs"][c][n])
                    for c in range(steps))
        layer.bn_mu.sub_(torch.as_tensor(drift))
        layer.b.data.copy_(torch.as_tensor(np.array(want["b"])))
        np.testing.assert_allclose(layer.bn_mu.numpy(), want["bn_mu"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(layer.bn_var.numpy(), want["bn_var"],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ppo.act_probs(aligned, torch.as_tensor(e)).numpy(),
        np.asarray(jppo.act_probs(jparams, e)), rtol=0, atol=1e-4)


def test_coordinator_over_testbed_matches_reference(monkeypatch):
    """test_ppo_and_sim.py's slot loop: capacities fixed at 100 queries,
    an update every 100 feedbacks, 3 Dirichlet(2) slots of 120 at SLO
    20 s.  Slot 0 runs before any update; slots 1 and 2 each after one.
    The policies are held in full after the first update; after the
    third, their params within 2 lr per Adam step only: by then the
    rounding noise of Adam's steps on near-zero gradients has spread
    from the biases into the weights, and the probabilities drift apart
    by more than 1e-4 even with the biases aligned."""
    seen = _record_biases(monkeypatch)
    ours_i, theirs_i = _identifiers(64, 4, 100)
    runs, first = [], []        # the policies after the first update
    for make, coord_cls, cap_cls, gen_cls, ident in (
            (cluster.make_paper_testbed, Coordinator, CapacityFunction,
             workload.QueryGenerator, ours_i),
            (jcluster.make_paper_testbed, JCoord, JCap, jwork.QueryGenerator,
             theirs_i)):
        nodes, _, _ = make(seed=0)
        for n in nodes:
            n.capacity = cap_cls(100.0, 0.0, [])
        coord = coord_cls(nodes, ident, seed=3)
        log, slots = [], []
        _record(coord, log)
        for qs in gen_cls(seed=1).dirichlet_slots(3, 120, alpha=2.0):
            m = coord.run_slot(qs, slo_s=20.0)
            assert m.n_queries == 120
            assert 0.0 <= m.quality_mean <= 1.0 and 0.0 <= m.drop_rate <= 1.0
            slots.append(((m.quality_mean, m.drop_rate,
                           m.per_node_load.tolist(), m.n_queries),
                          ident.updates_done, ident.buffered(),
                          np.stack([q.embedding for q in qs])))
            if ident.updates_done == 1 and len(slots) == 1:
                first.append(copy.deepcopy(ident.policy) if ident is ours_i
                             else jax.tree_util.tree_map(np.asarray,
                                                         ident.params))
        runs.append((coord, log, slots))
    (c_o, log_o, slots_o), (c_t, log_t, slots_t) = runs
    assert isinstance(c_o.identifier, QueryRouter)
    assert isinstance(c_o, SlotScheduler)
    for j in range(3):
        (_, p_o, *rest_o), (_, p_t, *rest_t) = log_o[2 * j], log_t[2 * j]
        if j == 0:      # before any update
            np.testing.assert_allclose(p_o, p_t, rtol=0, atol=1e-6)
        assert rest_o == rest_t, j                   # assignments, props
        assert log_o[2 * j + 1] == log_t[2 * j + 1], j   # every result
        assert slots_o[j][:3] == slots_t[j][:3], j   # metrics, updates
    assert [s[1] for s in slots_o] == [1, 2, 3]
    assert len(seen["ours"]) == len(seen["theirs"]) == \
        3 * ours_i.update_epochs
    _assert_policy_close(*first, seen, ours_i.update_epochs, slots_o[0][3])
    _assert_policy_close(ours_i.policy,
                         jax.tree_util.tree_map(np.asarray, theirs_i.params),
                         seen, 3 * ours_i.update_epochs, slots_o[2][3],
                         full=False)


def test_runtime_drives_simulated_nodes_like_reference():
    """test_cluster_runtime.py's protocol test through the port's
    ClusterRuntime: the simulated nodes pass the port's protocols and the
    runtime drives them unchanged (simulated latencies are 0.0), equal to
    the reference's runtime over its testbed."""
    dim = 256
    ours_i, theirs_i = _identifiers(dim, 4, 256)
    assert isinstance(ours_i, QueryRouter)
    got = []
    for make, rt_cls, q_cls, ident in (
            (cluster.make_paper_testbed, ClusterRuntime, cluster.Query,
             ours_i),
            (jcluster.make_paper_testbed, JRuntime, jcluster.Query,
             theirs_i)):
        nodes, _, _ = make(seed=0)
        for n in nodes:
            n.scheduler.iters = 40
        runtime = rt_cls(nodes, ident, use_inter_node=False)
        rng = np.random.default_rng(0)
        queries = [q_cls(d % 6, rng.standard_normal(dim), qid=d)
                   for d in range(4)]
        log = []
        _record(runtime, log)
        m = runtime.run_slot(queries, slo_s=20.0)
        got.append((m.n_queries, m.latency_p50, m.latency_p95,
                    m.quality_mean, m.drop_rate, m.per_node_load.tolist(),
                    [entry[2:] for entry in log if entry[0] == "route"],
                    [entry for entry in log if entry[0] == "results"]))
        if rt_cls is ClusterRuntime:
            assert all(isinstance(n, SchedulableNode) for n in nodes)
            assert isinstance(runtime, SlotScheduler)
    assert got[0] == got[1]
    assert got[0][0] == 4 and got[0][1] == 0.0
