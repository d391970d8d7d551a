"""The mirror-symmetry loss, port vs reference: the permutation matrices,
the loss and its gradient, and one PPO update with the loss on.

Weights are carried across from flax param trees (networks.from_jax_params)
and the batch is made once with numpy and fed to both. Tolerances: the
matrices exactly; the loss rtol 1e-5 and its gradient atol 1e-6 (float32
on the CPU, summation order differs); parameters after one update 1e-4 and
the loss metrics rtol 1e-4, as for the update without the loss
(test_torch_algo).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
from humanoid_tpu.algo import networks as jnet
from humanoid_tpu.algo import ppo as jppo
from humanoid_tpu.algo import symmetry as jsym
from humanoid_tpu_torch.algo import networks as tnet
from humanoid_tpu_torch.algo import symmetry as tsym
from humanoid_tpu_torch.algo.ppo import Adam, Batch, ppo_update, symmetry_loss
import humanoid_tpu_torch.config.structs as tcfg

OBS, PRIV, ACT = 705, 219, 12


@pytest.mark.parametrize("frame_stack,nj", [(15, 12), (1, 12), (15, 18), (1, 18)])
def test_perm_matrices_match_reference(frame_stack, nj):
    jo, ja = jsym.xbot_perm_matrices(frame_stack=frame_stack, nj=nj)
    to, ta = tsym.xbot_perm_matrices(frame_stack=frame_stack, nj=nj)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ta, ja)
    assert tuple(tsym.single_obs_permutation(nj)) == tuple(jsym.single_obs_permutation(nj))
    # a mirror twice is the identity
    np.testing.assert_array_equal(to @ to, np.eye(to.shape[0], dtype=np.float32))


def test_unknown_dof_count_has_no_mirror():
    with pytest.raises(ValueError):
        tsym.act_permutation(10)


def _nets(seed):
    net = jnet.ActorCritic(num_actions=ACT, compute_dtype="float32")
    params = jnet.init_params(jax.random.PRNGKey(seed), net, OBS, PRIV)
    params["params"]["std"] = jnp.linspace(0.5, 1.5, ACT)
    tn = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT),
                              jax.tree.map(lambda x: np.array(x), params))
    return net, params, tn


@pytest.mark.parametrize("seed", [0, 1])
def test_symmetry_loss_and_gradient_match_reference(seed):
    """The loss term of the reference's update (algo/ppo.py: the actor's
    mean on obs against the mirrored mean on mirrored obs) and its gradient
    in every actor parameter."""
    net, params, tn = _nets(seed)
    obs = np.random.default_rng(seed).normal(size=(64, OBS)).astype(np.float32)
    jop, jap = (jnp.asarray(x) for x in jsym.xbot_perm_matrices(15, ACT))

    def jloss(p):
        mean = net.apply(p, obs, method="act_mean")
        mirror = net.apply(p, obs @ jop, method="act_mean") @ jap
        return jnp.mean(jnp.square(mean - mirror))

    jl, jg = jax.value_and_grad(jloss)(params)
    top, tap = (torch.as_tensor(x) for x in tsym.xbot_perm_matrices(15, ACT))
    tobs = torch.as_tensor(obs)
    tl = symmetry_loss(tn, tobs, tn.act_mean(tobs), top, tap)
    grads = torch.autograd.grad(tl, list(tn.actor.parameters()))
    tl = float(tl.detach())
    assert tl > 1e-4
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    jactor = jg["params"]["actor"]
    for i in range(len(tn.actor.layers)):
        gw, gb = grads[2 * i], grads[2 * i + 1]
        np.testing.assert_allclose(gw.numpy().T, np.asarray(jactor[f"Dense_{i}"]["kernel"]),
                                   atol=1e-6, err_msg=f"Dense_{i} kernel")
        np.testing.assert_allclose(gb.numpy(), np.asarray(jactor[f"Dense_{i}"]["bias"]),
                                   atol=1e-6, err_msg=f"Dense_{i} bias")


def _batch(seed, B=64):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(B, ACT)).astype(np.float32) * 0.3
    actions = (mu + rng.normal(size=(B, ACT))).astype(np.float32)
    sigma = np.ones((B, ACT), np.float32)
    return dict(obs=rng.normal(size=(B, OBS)).astype(np.float32),
                critic_obs=rng.normal(size=(B, PRIV)).astype(np.float32), actions=actions,
                old_logp=np.asarray(jnet.log_prob(mu, sigma, actions)), old_mu=mu,
                old_sigma=sigma, target_values=rng.normal(size=B).astype(np.float32),
                advantages=rng.normal(size=B).astype(np.float32),
                returns=rng.normal(size=B).astype(np.float32))


def test_update_with_symmetry_loss_matches_reference():
    """One update (2 epochs x 4 minibatches) with sym_loss on, sym_coef 1,
    from an identical batch and tile permutation."""
    net, params, tn = _nets(3)
    batch = _batch(3)
    key = jax.random.PRNGKey(11)
    vel_slice = (53, 56)
    jop, jap = jsym.xbot_perm_matrices(15, ACT)
    acfg = jcfg.AlgorithmCfg(learning_rate=1e-3, sym_loss=True, sym_coef=1.0)
    ts, jm = jppo.ppo_update(net, acfg, jppo.init_train_state(params, acfg),
                             jppo.Batch(**batch), key, vel_slice, jnp.asarray(jop),
                             jnp.asarray(jap))
    g = acfg.shuffle_granule
    tiles = np.asarray(jax.random.permutation(key, 64 // g))
    perm = torch.as_tensor((tiles[:, None] * g + np.arange(g)).reshape(-1))
    tbatch = Batch(**{k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    tacfg = tcfg.AlgorithmCfg(learning_rate=1e-3, sym_loss=True, sym_coef=1.0)
    before = [p.detach().clone() for p in tn.parameters()]
    opt = Adam(list(tn.parameters()), tacfg.max_grad_norm, tacfg.learning_rate)
    tm = ppo_update(tn, tacfg, opt, tbatch, perm, vel_slice, torch.as_tensor(jop),
                    torch.as_tensor(jap))
    after = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT),
                                 jax.tree.map(lambda x: np.array(x), ts.params))
    for (name, p), q in zip(tn.named_parameters(), after.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-4,
                                   err_msg=name)
    assert float(jm.sym_loss) > 1e-4
    np.testing.assert_allclose(float(tm.sym_loss), float(jm.sym_loss), rtol=1e-4)
    np.testing.assert_allclose(float(tm.value_loss), float(jm.value_loss), rtol=1e-4)
    np.testing.assert_allclose(float(tm.lr), float(ts.lr), rtol=1e-6)
    # control: the same update without the loss lands elsewhere
    _, _, tn0 = _nets(3)
    for p, q in zip(tn0.parameters(), before):
        assert torch.equal(p.detach(), q)
    opt0 = Adam(list(tn0.parameters()), tacfg.max_grad_norm, tacfg.learning_rate)
    m0 = ppo_update(tn0, tcfg.AlgorithmCfg(learning_rate=1e-3), opt0, tbatch, perm, vel_slice)
    assert float(m0.sym_loss) == 0.0
    moved = max(float((p - q).abs().max()) for p, q in zip(tn.actor.parameters(),
                                                           tn0.actor.parameters()))
    assert moved > 1e-4, moved
