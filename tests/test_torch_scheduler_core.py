"""The port's inter-node scheduling layer against the reference on the
CPU: Algorithm 1 (``inter_node_schedule``) over its inflate, reassign
and zero-mass branches, ``profile_capacity`` over a synthetic serve
function, the arrival traces, ``autoscale_knobs``, the replay summary
and the structural protocols.  Everything here is numpy in both
packages and is compared exactly."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.cluster.replay import ReplayReport as JReport  # noqa: E402
from repro.cluster.replay import autoscale_knobs as j_knobs  # noqa: E402
from repro.cluster.runtime import ClusterSlotMetrics as JMetrics  # noqa: E402
from repro.core.inter_node import inter_node_schedule as j_schedule  # noqa: E402
from repro.core.inter_node import profile_capacity as j_profile  # noqa: E402
from repro.data import traces as j_traces  # noqa: E402

from repro_torch.cluster import (ClusterRuntime, ClusterSlotMetrics,  # noqa: E402
                                 LiveEdgeNode, ReplayReport,
                                 autoscale_knobs)
from repro_torch.core.identifier import OnlineQueryIdentifier  # noqa: E402
from repro_torch.core.inter_node import (CapacityFunction,  # noqa: E402
                                         inter_node_schedule,
                                         profile_capacity)
from repro_torch.core.protocols import QueryRouter, SlotScheduler  # noqa: E402
from repro_torch.data import traces  # noqa: E402


def _probs(rng, B, N, zero_cols=()):
    p = rng.random((B, N)).astype(np.float32) ** 3
    for c in zero_cols:
        p[:, c] = 0.0
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("B,caps,zero_cols", [
    (12, [100.0, 100.0, 100.0], ()),          # room everywhere
    (40, [5.0, 9.0, 3.0], ()),                # demand > total: inflate
    (30, [2.0, 40.0, 40.0], ()),              # node 0 fills: reassign
    (30, [30.0, 3.0, 3.0], (0,)),             # node 0 has no mass:
    (25, [1.0, 1.0, 30.0], (2,)),             # reassign with zero mass
    (1, [0.5, 0.5], ()),
    (64, [1e9, 1.0], ()),
], ids=["room", "inflate", "reassign", "zero-mass", "zero-mass-2", "one",
        "lopsided"])
def test_inter_node_schedule_matches_reference(B, caps, zero_cols):
    for seed in range(3):
        probs = _probs(np.random.default_rng(seed), B, len(caps), zero_cols)
        caps_a = np.asarray(caps)
        a1, p1 = inter_node_schedule(probs, caps_a,
                                     np.random.default_rng(100 + seed))
        a2, p2 = j_schedule(probs, caps_a, np.random.default_rng(100 + seed))
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(p1, p2)
        assert a1.min() >= 0 and a1.max() < len(caps)
        assert p1.sum() == pytest.approx(1.0)


def test_inter_node_schedule_respects_capacity():
    probs = _probs(np.random.default_rng(5), 30, 3, (0,))
    a, props = inter_node_schedule(probs, np.array([30.0, 3.0, 3.0]),
                                   np.random.default_rng(0))
    counts = np.bincount(a, minlength=3)
    assert counts[1] <= 3 and counts[2] <= 3     # full nodes spill over
    assert counts[0] == 24                       # ... to the one with room
    np.testing.assert_array_equal(props, counts / 30)


@pytest.mark.parametrize("k,b", [(3.0, 7.0), (0.4, 1.0), (11.0, -2.0)])
def test_profile_capacity_matches_reference(k, b):
    """A node that drops the share of a burst above k L + b."""
    calls = []

    def serve(n, L):
        calls.append((n, L))
        cap = max(1.0, k * L + b)
        return max(0.0, (n - cap) / n)

    ours = profile_capacity(serve)
    n_ours = len(calls)
    theirs = j_profile(serve)
    assert calls[:n_ours] == calls[n_ours:]
    assert (ours.k, ours.b, ours.levels) == (theirs.k, theirs.b,
                                             theirs.levels)
    for L in (1.0, 5.0, 42.0):
        assert ours(L) == theirs(L)
    assert isinstance(ours, CapacityFunction)


@pytest.mark.parametrize("name", ["diurnal_volume_trace",
                                  "spike_volume_trace", "ramp_volume_trace"])
def test_volume_traces_match_reference(name):
    for seed in range(3):
        assert getattr(traces, name)(24, base=12, seed=seed) == \
            getattr(j_traces, name)(24, base=12, seed=seed)


def test_domain_trace_matches_reference():
    for a, b in zip(traces.dirichlet_domain_trace(6, 5, 1.5, seed=2),
                    j_traces.dirichlet_domain_trace(6, 5, 1.5, seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [(4.0, 4, 12.0, 40.0), (0.5, 8, 1.0, 5.0),
                                  (100.0, 2, 300.0, 200.0)])
def test_autoscale_knobs_match_reference(args):
    assert autoscale_knobs(*args) == j_knobs(*args)


def test_replay_summary_matches_reference():
    rng = np.random.default_rng(0)
    slots = []
    for n in (5, 0, 9, 3):
        fields = dict(quality_mean=float(rng.random()),
                      drop_rate=float(rng.random()),
                      per_node_load=rng.random(2), n_queries=n,
                      latency_p50=float(rng.random()),
                      latency_p95=float(rng.random() + 1),
                      latency_mean=float(rng.random()),
                      load_imbalance=float(rng.random() + 1),
                      ppo_updates=n // 3, slo_firing=n % 2)
        slots.append(fields)
    ours = ReplayReport([ClusterSlotMetrics(**f) for f in slots])
    theirs = JReport([JMetrics(**f) for f in slots])
    assert ours.summary() == theirs.summary()
    assert ReplayReport().summary() == JReport().summary()


def test_structural_protocols():
    # a node instance is checked in test_torch_runtime.py
    assert callable(LiveEdgeNode.process_slot) and \
        callable(LiveEdgeNode.profile)
    ident = OnlineQueryIdentifier(8, 2, device="cpu")
    assert isinstance(ident, QueryRouter)
    assert isinstance(ClusterRuntime([], ident), SlotScheduler)
