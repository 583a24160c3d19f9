"""The port's PPO policy and online identifier against the reference on
the CPU.

Both sides start from the reference's policy params, carried across by
``bridge.policy_from_numpy``; embeddings, actions and feedback are made
with numpy from a seed.  Tolerances: logits within 1e-5 and
standardized feedback within 1e-6 (the same f32 math in another order),
the update's loss, entropy and mean ratio within a relative 1e-5;
after updates, params within 2 * lr * (the number of Adam steps): Adam's
first step moves a parameter by about lr times the sign of its
gradient, so a gradient near zero whose sign the summation order flips
moves the two sides up to 2 lr apart a step.  The hidden layers' biases
``b`` are such parameters everywhere: batch norm subtracts them in the
train forward, so their true gradient is 0 and both packages move them
by +-lr on the sign of rounding noise.  Eval mode does not subtract
them, so they shift the probabilities by up to a few 1e-4; the
probabilities are held within 1e-4 once those biases are aligned (the
rest of the policy as each package left it)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.core import ppo as jppo  # noqa: E402
from repro.core.identifier import OnlineQueryIdentifier as JIdent  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import ppo  # noqa: E402
from repro_torch.core.identifier import OnlineQueryIdentifier  # noqa: E402

D, N, LR = 24, 3, 3e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, B=20):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((B, D)).astype(np.float32)
    a = rng.integers(0, N, B).astype(np.int32)
    f = rng.random(B).astype(np.float32)
    return e, a, f


def _assert_params_close(policy, jparams, atol):
    ours = bridge.policy_to_numpy(policy)["layers"]
    theirs = _np(jparams)["layers"]
    assert len(ours) == len(theirs)
    for mine, want in zip(ours, theirs):
        assert sorted(mine) == sorted(want)
        for name in want:
            np.testing.assert_allclose(mine[name], want[name], rtol=0,
                                       atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jparams():
    return jppo.init_policy(jax.random.PRNGKey(0), D, N)


def test_init_matches_reference_layout():
    """The port's own init draws other numbers but has the reference's
    layers, names and shapes, on the CPU and as numpy."""
    ours = bridge.policy_to_numpy(ppo.init_policy(0, D, N, device="cpu"))
    theirs = _np(jppo.init_policy(jax.random.PRNGKey(0), D, N))
    assert [{k: v.shape for k, v in layer.items()}
            for layer in ours["layers"]] == \
        [{k: v.shape for k, v in layer.items()} for layer in theirs["layers"]]
    again = bridge.policy_to_numpy(ppo.init_policy(0, D, N, device="cpu"))
    for a, b in zip(ours["layers"], again["layers"]):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_policy_logits_match_reference(jparams, train):
    e, _, _ = _batch(1)
    want, jnew = jppo.policy_logits(jparams, jnp.asarray(e), train=train)
    policy = bridge.policy_from_numpy(_np(jparams), "cpu")
    got = ppo.policy_logits(policy, torch.as_tensor(e), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    # the running stats after the forward (unchanged in eval mode)
    _assert_params_close(policy, jnew, 1e-5)


def test_act_probs_match_reference(jparams):
    e, _, _ = _batch(2)
    policy = bridge.policy_from_numpy(_np(jparams), "cpu")
    got = ppo.act_probs(policy, torch.as_tensor(e)).numpy()
    np.testing.assert_allclose(got, np.asarray(jppo.act_probs(
        jparams, jnp.asarray(e))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("f", [
    np.array([0.1, 0.5, 0.9, 0.3, 0.0], np.float32),
    np.array([0.7, 0.7, 0.7], np.float32),
    np.random.default_rng(3).random(64).astype(np.float32),
], ids=["five", "constant", "64"])
def test_standardize_feedback_matches_reference(f):
    got = ppo.standardize_feedback(torch.as_tensor(f)).numpy()
    want = np.asarray(jppo.standardize_feedback(jnp.asarray(f)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_one_ppo_update_matches_reference(jparams):
    """One clipped-surrogate Adam step from the same params, the old
    policy equal to the current one (as at the first epoch)."""
    e, a, f = _batch(4)
    jnew, jopt, jm = jppo.ppo_update(jparams, jparams,
                                     jppo.init_adam(jparams), jnp.asarray(e),
                                     jnp.asarray(a), jnp.asarray(f))
    policy = bridge.policy_from_numpy(_np(jparams), "cpu")
    old = copy.deepcopy(policy)
    m = ppo.ppo_update(policy, old, ppo.init_adam(policy, LR),
                       torch.as_tensor(e), torch.as_tensor(a),
                       torch.as_tensor(f))
    # the loss is large (rho of train-mode over eval-mode probabilities):
    # f32 agreement is relative
    for key in ("loss", "entropy", "rho"):
        assert m[key] == pytest.approx(float(jm[key]), rel=1e-5,
                                       abs=1e-5), key
    _assert_params_close(policy, jnew, 2 * LR * 1)
    e2, _, _ = _batch(5)
    np.testing.assert_allclose(
        _probs_aligned(policy, jnew, e2),
        np.asarray(jppo.act_probs(jnew, jnp.asarray(e2))), rtol=0, atol=1e-4)
    assert int(jopt["step"]) == 1


def _probs_aligned(policy, jparams, e):
    """act_probs of a copy of ``policy`` whose hidden pre-norm biases are
    the reference's (their updates are rounding noise; see above)."""
    aligned = copy.deepcopy(policy)
    for layer, want in zip(aligned.layers[:-1], _np(jparams)["layers"]):
        layer.b.data.copy_(torch.as_tensor(np.array(want["b"])))
    return ppo.act_probs(aligned, torch.as_tensor(e)).numpy()


def _pair(jident):
    ours = OnlineQueryIdentifier(D, N, seed=7, update_threshold=32,
                                 update_epochs=4, device="cpu")
    ours.load_policy(bridge.policy_from_numpy(_np(jident.params), "cpu"))
    return ours


def test_identifier_matches_reference():
    """identify, sample_actions, feedback, buffered, maybe_update and
    updates_done over two update rounds (the Adam state persists across
    them)."""
    theirs = JIdent(D, N, seed=7, update_threshold=32, update_epochs=4)
    ours = _pair(theirs)
    probe, _, _ = _batch(99, B=16)
    steps = 0
    for step in range(4):                       # 20 queries a slot
        e, _, f = _batch(10 + step)
        p_theirs = theirs.identify(e)
        np.testing.assert_allclose(_probs_aligned(ours.policy, theirs.params,
                                                  e), p_theirs, rtol=0,
                                   atol=1e-4)
        if not steps:
            np.testing.assert_allclose(ours.identify(e), p_theirs, rtol=0,
                                       atol=1e-5)
        a_ours = ours.sample_actions(p_theirs)
        a_theirs = theirs.sample_actions(p_theirs)
        np.testing.assert_array_equal(a_ours, a_theirs)
        ours.feedback(e, a_ours, f)
        theirs.feedback(e, a_theirs, f)
        assert ours.buffered() == theirs.buffered()
        m_ours, m_theirs = ours.maybe_update(), theirs.maybe_update()
        assert (m_ours is None) == (m_theirs is None)
        if m_ours is not None:
            steps += ours.update_epochs
            assert m_ours["entropy"] == pytest.approx(m_theirs["entropy"],
                                                      abs=1e-4)
        assert ours.updates_done == theirs.updates_done
        assert ours.buffered() == theirs.buffered()
        np.testing.assert_allclose(_probs_aligned(ours.policy, theirs.params,
                                                  probe),
                                   theirs.identify(probe), rtol=0, atol=1e-4)
        _assert_params_close(ours.policy, theirs.params,
                             2 * LR * max(steps, 1))
    assert ours.updates_done == 2 and steps == 8


def test_identifier_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineQueryIdentifier(D, N)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo.init_policy(0, D, N)


def test_running_means_follow_the_bias_drift(monkeypatch):
    """The running means differ from the reference's only by what the
    hidden biases' rounding-noise drift averages in: each epoch's train
    forward adds 0.1 * its batch mean, which holds that epoch's bias, so
    over the epochs c the means drift by
    sum_c 0.1 * 0.9**(epochs after c) * (b_ours_c - b_theirs_c).
    Less that drift, the means match within allclose(atol 1e-5, rtol
    1e-4); the variances (bias-free) match as they are."""
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
    theirs = JIdent(D, N, seed=7, update_threshold=32, update_epochs=4)
    ours = _pair(theirs)
    for step in range(4):
        e, _, f = _batch(10 + step)
        a = theirs.sample_actions(theirs.identify(e))
        np.testing.assert_array_equal(ours.sample_actions(
            theirs.identify(e)), a)
        ours.feedback(e, a, f)
        theirs.feedback(e, a, f)
        ours.maybe_update()
        theirs.maybe_update()
    n_ep = len(seen["ours"])
    assert n_ep == len(seen["theirs"]) == 8
    want = _np(theirs.params)["layers"]
    drift_seen = 0.0
    for n, layer in enumerate(ours.policy.layers[:-1]):
        drift = sum((1 - ppo.BN_MOMENTUM) * ppo.BN_MOMENTUM ** (n_ep - 1 - c)
                    * (seen["ours"][c][n] - seen["theirs"][c][n])
                    for c in range(n_ep))
        drift_seen = max(drift_seen, float(np.abs(drift).max()))
        np.testing.assert_allclose(layer.bn_mu.numpy() - drift,
                                   want[n]["bn_mu"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(layer.bn_var.numpy(), want[n]["bn_var"],
                                   rtol=1e-4, atol=1e-5)
    assert drift_seen > 1e-5   # the drift is real here, not vacuous
