"""The port's OCO intra-node scheduler (``IntraNodeScheduler.schedule``)
against the reference on the CPU, on each node of the paper's testbed,
over loads and latency budgets.  Both are the same numpy code, so the
tolerance is 0: ``p``, ``R``, the objective, the per-GPU loading times,
the predicted per-GPU latencies and feasibility compare with ``==``.
The solver runs 40 projected-gradient iterations to keep the file short;
one case runs the default 200."""
import pytest

pytest.importorskip("torch")

from repro.core import cluster as jcluster  # noqa: E402

from repro_torch.core import cluster  # noqa: E402

LOADS = (1, 20, 75, 300)
BUDGETS = (1.0, 5.0, 14.85)     # 14.85: SLO 15 s less the 0.15 s search


@pytest.fixture(scope="module")
def testbeds():
    return (cluster.make_paper_testbed(seed=0)[0],
            jcluster.make_paper_testbed(seed=0)[0])


def _alloc(a):
    return (a.p, a.R, a.objective, a.tl_per_gpu, a.predicted_gpu_latency,
            a.feasible)


def _schedule(node, load, budget, iters):
    node.scheduler.iters = iters
    return _alloc(node.scheduler.schedule(load, budget))


@pytest.mark.parametrize("load", LOADS)
@pytest.mark.parametrize("node_id", [0, 1, 2, 3])
def test_schedule_matches_reference(testbeds, node_id, load):
    ours, theirs = testbeds[0][node_id], testbeds[1][node_id]
    for budget in BUDGETS:
        got = _schedule(ours, load, budget, 40)
        assert got == _schedule(theirs, load, budget, 40), budget
        if budget > 5.0:        # a feasible deployment serves queries
            assert got[5] and got[2] > 0, (load, budget)
    assert ours.mgr.R == theirs.mgr.R == [{}] * ours.num_gpus


def test_schedule_default_iterations_matches_reference(testbeds):
    ours, theirs = testbeds[0][1], testbeds[1][1]
    got = _schedule(ours, 75, 14.85, 200)
    assert got == _schedule(theirs, 75, 14.85, 200)
    assert got[-1] and got[2] > 0


def test_schedule_from_a_deployment_matches_reference():
    """After a transition applied by the pool manager: persistent models
    pay no load time when their R snaps back, fresh ones do."""
    got = []
    for make in (cluster.make_paper_testbed, jcluster.make_paper_testbed):
        node = make(seed=0)[0][2]
        node.scheduler.iters = 40
        first = node.scheduler.schedule(120, 14.85)
        node.mgr.apply(first.r_alloc())
        got.append([_alloc(node.scheduler.schedule(load, budget))
                     for load, budget in ((120, 14.85), (300, 5.0))])
    assert got[0] == got[1]
