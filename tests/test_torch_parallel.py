"""Data-parallel training over ranks in the port (parallel/dist.py,
parallel/mesh.py, train --mesh/--multihost, sweep, bench_scaling).

W ranks, each on its share of the envs, must train as one process with all
of them would, as the reference's sharded run does under GSPMD
(tests/test_parallel.py, tests/test_multiprocess.py). The multi-process
cases start 2 local gloo ranks through
parallel/dist.py::launch (localhost rendezvous, one thread each, no
tensorboard), each with a timeout of its own after which every rank is
killed and the test fails. Bounds: the reference's own for the sharded
run against one device (tests/test_parallel.py: mean step reward atol
1e-5, parameters atol 5e-4); tests/test_torch_algo.py's for the update
against the reference's (parameters 1e-4, learning rate rtol 1e-6, value
loss rtol 1e-4, KL rtol 1e-3); 1e-6 for the global mean and std in
float32.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import humanoid_tpu.config.structs as jcfg
from humanoid_tpu.algo import networks as jnet
from humanoid_tpu.algo import ppo as jppo
from humanoid_tpu.scripts.sweep import _coerce as ref_coerce
from humanoid_tpu.scripts.sweep import _expand_grid as ref_expand_grid
from humanoid_tpu.scripts.sweep import apply_point as ref_apply_point
from humanoid_tpu_torch.algo import networks as tnet
from humanoid_tpu_torch.algo.ppo import Adam, Batch, ppo_update, tile_permutation
from humanoid_tpu_torch.config import structs as tcfg
from humanoid_tpu_torch.parallel import dist, mesh
from humanoid_tpu_torch.scripts import bench_scaling, sweep, train
from humanoid_tpu_torch.utils import registry

OBS, PRIV, ACT = 705, 219, 12
TIMEOUT = 120                     # seconds per launch of the ranks
# a rank: no tensorboard (its import takes seconds), one thread
RANK_PRELUDE = r"""
import sys
sys.modules["tensorboard"] = None
import torch
torch.set_num_threads(1)
"""
# a rank of a training run: the task's configs with a point's overrides
# (sweep.apply_point), then rank_view (train --mesh) with the arguments
TRAIN_RANK = RANK_PRELUDE + r"""
import json
from humanoid_tpu_torch.scripts.sweep import apply_point
from humanoid_tpu_torch.utils import registry
from humanoid_tpu_torch.parallel import rank_view
point = json.loads(sys.argv[1])
task_cfgs = registry.get_cfgs
registry.get_cfgs = lambda name: apply_point(*task_cfgs(name), point)
rank_view.main(sys.argv[2:])
"""
# a rank of the collective checks: global_mean_std on its rows of x, and
# ppo_update on its rows of the global batch for each permutation
UPDATE_RANK = RANK_PRELUDE + r"""
import os
import numpy as np
from humanoid_tpu_torch.algo import networks as tnet
from humanoid_tpu_torch.algo.ppo import Adam, Batch, ppo_update
from humanoid_tpu_torch.config.structs import AlgorithmCfg
from humanoid_tpu_torch.parallel import dist, mesh
d = sys.argv[1]
data = np.load(os.path.join(d, "data.npz"))
T, N = int(data["T"]), int(data["N"])
dist.init_from_env("cpu")
rank, world = dist.process_index(), dist.process_count()
shard = mesh.make_shard(N, rank, world, int(data["granule"]))
rows = lambda x: torch.as_tensor(x.reshape(T, N, *x.shape[1:])[:, shard.offset:shard.offset
                                 + shard.n_local].reshape(T * shard.n_local, *x.shape[1:]))
out = {"mean_std": [v.item() for v in mesh.global_mean_std(rows(data["x"]), shard)],
       "offset": shard.offset}
acfg = AlgorithmCfg(learning_rate=1e-3, num_mini_batches=2)
batch = Batch(**{k: rows(data[k]) for k in Batch._fields})
for name in ("perm", "perm_empty"):
    net = tnet.ActorCritic(705, 219, 12)
    net.load_state_dict(torch.load(os.path.join(d, "net.pt")))
    opt = Adam(list(net.parameters()), acfg.max_grad_norm, acfg.learning_rate)
    m = ppo_update(net, acfg, opt, batch, torch.as_tensor(data[name]), (53, 56), shard=shard)
    out[name] = {"params": {k: v.detach() for k, v in net.named_parameters()},
                 "mu": opt.mu, "nu": opt.nu, "lr": m.lr.item(),
                 "value_loss": m.value_loss.item(), "kl": m.kl.item(),
                 "rows": [len(r) for r in mesh.minibatch_rows(
                     torch.as_tensor(data[name]).reshape(acfg.num_mini_batches, -1), shard)]}
torch.save(out, os.path.join(d, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
"""
# 2 iterations at T = 4, 1 epoch of 2 minibatches, float32
SMALL = {"runner.num_steps_per_env": 4, "algorithm.num_learning_epochs": 1,
         "algorithm.num_mini_batches": 2, "policy.compute_dtype": "float32"}
# humanoid_ppo_robust (its randomizations, gait schedule and lag) with
# 4-step episodes and commands below the stand threshold (tracked well), so
# that the command curriculum widens within the run: at step 4 on episodes
# that end on rank 0 alone, at step 8 on episodes that end on both ranks
CURRICULUM = {**SMALL, "env.episode_length_s": 0.045, "commands.curriculum": True,
              "commands.ranges.lin_vel_x": [-0.1, 0.1],
              "commands.ranges.lin_vel_y": [-0.1, 0.1]}


@pytest.fixture(autouse=True)
def one_thread():
    """This process's own training runs on one thread, as the ranks do: the
    suite's other workers hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def launch(code, args, log_dir, world=2):
    return dist.launch(world, ["-c", code, *map(str, args)], timeout=TIMEOUT,
                       log_dir=str(log_dir))


@pytest.fixture
def small_cfgs(monkeypatch):
    """registry.get_cfgs with a point's overrides, in this process."""
    task_cfgs = registry.get_cfgs

    def use(point):
        monkeypatch.setattr(registry, "get_cfgs",
                            lambda name: sweep.apply_point(*task_cfgs(name), point))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    return use


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# world 1


def test_world_one_helpers_are_the_identity(monkeypatch):
    for var in dist.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not dist.launched() and not dist.init_from_env("cpu")
    assert not torch.distributed.is_initialized()
    assert (dist.process_index(), dist.process_count(), dist.is_main()) == (0, 1, True)
    assert dist.sync_run_name("Oct17_10-00-00_run") == "Oct17_10-00-00_run"
    assert dist.device_for_rank("cpu") == torch.device("cpu")
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    for shard in (None, mesh.make_shard(4, 0, 1, 8)):
        assert mesh.all_reduce_sum(x, shard) is x
        mean, std = mesh.global_mean_std(x, shard)
        assert same_bits(mean, x.mean()) and same_bits(std, x.std(correction=0))
        a = mesh.draw(shard, torch.randint, 0, 9, size=(4, 3),
                      generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, torch.randint(0, 9, (4, 3),
                                            generator=torch.Generator().manual_seed(1)))
    assert not torch.distributed.is_initialized()


def test_draw_keeps_this_ranks_rows_of_the_global_draw():
    full = torch.rand(12, 5, generator=torch.Generator().manual_seed(3))
    for rank in range(3):
        shard = mesh.make_shard(12, rank, 3)
        part = mesh.draw(shard, torch.rand, size=(4, 5),
                         generator=torch.Generator().manual_seed(3))
        assert torch.equal(part, full[4 * rank:4 * rank + 4])
    with pytest.raises(ValueError):
        mesh.draw(mesh.make_shard(12, 0, 3), torch.rand, size=(12, 5))


def test_shard_rules():
    assert mesh.make_shard(4096, 1, 2, 8) == mesh.EnvShard(1, 2, 2048, 2048, 4096)
    with pytest.raises(ValueError, match="split evenly"):
        mesh.make_shard(10, 0, 4)
    with pytest.raises(ValueError, match="shuffle granule"):
        mesh.make_shard(24, 0, 2, 8)
    assert mesh.make_shard(37, 0, 1, 8).n_local == 37     # one rank: any count


@pytest.mark.parametrize("T,N,W,granule", [(4, 16, 2, 8), (6, 32, 4, 8), (3, 24, 3, 1),
                                           (5, 8, 2, 4), (2, 64, 8, 8)])
def test_row_map_covers_each_minibatch(T, N, W, granule):
    """The union over the ranks of each minibatch's local rows, mapped
    back to global rows, is exactly the global minibatch, once each."""
    acfg = tcfg.AlgorithmCfg(num_mini_batches=4, shuffle_granule=granule)
    perm = tile_permutation(T * N, acfg, torch.Generator().manual_seed(T * N), "cpu")
    idx = perm.reshape(acfg.num_mini_batches, -1)
    got = [[] for _ in range(len(idx))]
    for r in range(W):
        shard = mesh.make_shard(N, r, W, granule)
        for j, local in enumerate(mesh.minibatch_rows(idx, shard)):
            t, n = local // shard.n_local, local % shard.n_local + shard.offset
            got[j] += (t * N + n).tolist()
            assert ((local >= 0) & (local < T * shard.n_local)).all()
    for j in range(len(idx)):
        assert sorted(got[j]) == sorted(idx[j].tolist())


# ---------------------------------------------------------------------------
# the collectives and the update over 2 ranks, against the reference


@pytest.fixture(scope="module")
def update_ranks(tmp_path_factory):
    """2 ranks of UPDATE_RANK on one global batch (T = 4, N = 16), the
    reference's update on the whole batch for each of two tile
    permutations: jax.random.permutation's, and one whose first minibatch
    holds no row of rank 1."""
    d = tmp_path_factory.mktemp("update_ranks")
    T, N, B, g = 4, 16, 64, 8
    rng = np.random.default_rng(3)
    net = jnet.ActorCritic(num_actions=ACT, compute_dtype="float32")
    params = jnet.init_params(jax.random.PRNGKey(3), net, OBS, PRIV)
    params["params"]["std"] = jnp.linspace(0.5, 1.5, ACT)
    mu = rng.normal(size=(B, ACT)).astype(np.float32) * 0.3
    actions = (mu + rng.normal(size=(B, ACT))).astype(np.float32)
    sigma = np.ones((B, ACT), np.float32)
    batch = dict(obs=rng.normal(size=(B, OBS)).astype(np.float32),
                 critic_obs=rng.normal(size=(B, PRIV)).astype(np.float32),
                 actions=actions, old_logp=np.asarray(jnet.log_prob(mu, sigma, actions)),
                 old_mu=mu, old_sigma=sigma,
                 target_values=rng.normal(size=B).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=rng.normal(size=B).astype(np.float32))
    x = (rng.normal(size=B) * 3.0 + 1.5).astype(np.float32)
    keys = {"perm": jax.random.PRNGKey(11)}
    for k in range(1000):
        # tile k holds rows 8k..8k+7: t = k // 2, on rank k % 2
        tiles = np.asarray(jax.random.permutation(jax.random.PRNGKey(k), B // g))
        if (tiles[:4] % 2 == 0).all():
            keys["perm_empty"] = jax.random.PRNGKey(k)
            break
    perms = {n: (np.asarray(jax.random.permutation(key, B // g))[:, None] * g
                 + np.arange(g)).reshape(-1) for n, key in keys.items()}
    np.savez(d / "data.npz", T=T, N=N, granule=g, x=x, **batch, **perms)
    acfg = jcfg.AlgorithmCfg(learning_rate=1e-3, num_mini_batches=2)
    tn = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT),
                              jax.tree.map(np.array, params))
    torch.save(tn.state_dict(), d / "net.pt")
    tbatch = Batch(**{k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    ref = {}
    for name, key in keys.items():
        ts, jm = jppo.ppo_update(net, acfg, jppo.init_train_state(params, acfg),
                                 jppo.Batch(**batch), key, (53, 56))
        # and the port's update in one process on the whole batch
        one = tnet.ActorCritic(OBS, PRIV, ACT)
        one.load_state_dict(tn.state_dict())
        ppo_update(one, tcfg.AlgorithmCfg(learning_rate=1e-3, num_mini_batches=2),
                   Adam(list(one.parameters()), acfg.max_grad_norm, acfg.learning_rate),
                   tbatch, torch.as_tensor(perms[name]), (53, 56))
        ref[name] = (ts, jm, one)
    launch(UPDATE_RANK, [d], d / "logs")
    views = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    return x, ref, views


def test_global_mean_std_over_two_ranks(update_ranks):
    x, _, views = update_ranks
    for v in views:
        np.testing.assert_allclose(v["mean_std"][0], float(jnp.mean(x)), atol=1e-6)
        np.testing.assert_allclose(v["mean_std"][1], float(jnp.std(x)), atol=1e-6)
        np.testing.assert_allclose(v["mean_std"][1], float(torch.as_tensor(x).std(correction=0)),
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["perm", "perm_empty"])
def test_ppo_update_over_two_ranks_matches_reference(update_ranks, name):
    """The reference's tile permutation; and one whose first minibatch has
    no row on rank 1, whose parameters are held to the port's update in one
    process on the whole batch: at that permutation the one-process
    update itself already lies 8.7e-5 from the reference's on one weight
    (float32 Adam on a gradient near zero), the bound 1e-4."""
    _, ref, views = update_ranks
    ts, jm, one = ref[name]
    a, b = views[0][name], views[1][name]
    if name == "perm_empty":
        assert b["rows"][0] == 0 and a["rows"][0] == 32     # rank 1 joins with no rows
        expected = one
    else:
        expected = tnet.from_jax_params(tnet.ActorCritic(OBS, PRIV, ACT),
                                        jax.tree.map(np.array, ts.params))
    for n, q in expected.named_parameters():
        np.testing.assert_allclose(a["params"][n].numpy(), q.detach().numpy(), atol=1e-4,
                                   err_msg=n)
    np.testing.assert_allclose(a["lr"], float(ts.lr), rtol=1e-6)
    np.testing.assert_allclose(a["value_loss"], float(jm.value_loss), rtol=1e-4)
    np.testing.assert_allclose(a["kl"], float(jm.kl), rtol=1e-3, atol=1e-7)
    # the ranks agree in bits
    assert all(same_bits(a["params"][n], b["params"][n]) for n in a["params"])
    assert all(same_bits(x, y) for key in ("mu", "nu") for x, y in zip(a[key], b[key]))
    assert (a["lr"], a["value_loss"], a["kl"]) == (b["lr"], b["value_loss"], b["kl"])


# ---------------------------------------------------------------------------
# the slice: 2 ranks x 8 envs against 1 process x 16 envs


@pytest.mark.parametrize("task,point", [("humanoid_ppo", SMALL),
                                        ("humanoid_ppo_robust", CURRICULUM)],
                         ids=["humanoid_ppo", "command_curriculum"])
def test_two_ranks_train_as_one_process(task, point, tmp_path, small_cfgs, monkeypatch):
    argv = ["--task", task, "--device", "cpu", "--num-envs", "16", "--max-iterations", "2"]
    launch(TRAIN_RANK, [json.dumps(point), tmp_path / "views", *argv,
                        "--log-root", tmp_path / "ranks"], tmp_path / "logs")
    views = [torch.load(tmp_path / "views" / f"rank{r}.pt") for r in range(2)]

    # one process with every env, each step's resets and widenings noted
    from humanoid_tpu_torch.env.xbotl import XBotLEnv

    small_cfgs(point)
    widened, step = [], XBotLEnv.step

    def noting_step(self, state, actions, gen):
        new, out = step(self, state, actions, gen)
        if state.cmd_x_range is not None and not torch.equal(new.cmd_x_range,
                                                             state.cmd_x_range):
            widened.append(out.reset.reshape(2, 8).any(dim=1).tolist())
        return new, out

    monkeypatch.setattr(XBotLEnv, "step", noting_step)
    rows = []
    runner, carry = train.main([*argv, "--log-root", str(tmp_path / "one")],
                               log_fn=lambda it, m, fps: rows.append(m))

    a, b = views
    assert (a["world"], a["backend"], a["n_local"], b["offset"]) == (2, "gloo", 8, 8)
    for v in views:
        for r, m in zip(v["rows"], rows):
            np.testing.assert_allclose(float(r["mean_step_reward"]),
                                       float(m.mean_step_reward), atol=1e-5)
            assert float(r["ep_count"]) == float(m.ep_count)
        for n, p in runner.net.named_parameters():
            np.testing.assert_allclose(v["params"][n].numpy(), p.detach().numpy(), atol=5e-4,
                                       err_msg=n)
        assert all(torch.isfinite(x).all() for x in v["params"].values())
        assert torch.isfinite(v["obs"]).all() and torch.isfinite(v["critic_obs"]).all()
        assert v["loaded"] == []
    # the ranks agree in bits, on the parameters, Adam and the metrics
    assert all(same_bits(a["params"][n], b["params"][n]) for n in a["params"])
    assert all(same_bits(x, y) for k in ("adam_mu", "adam_nu") for x, y in zip(a[k], b[k]))
    assert a["adam_count"] == b["adam_count"] == 4 and same_bits(a["lr"], b["lr"])
    for r, s in zip(a["rows"], b["rows"]):
        assert all(same_bits(r[k], s[k]) for k in ("mean_step_reward", "value_loss", "kl",
                                                   "ep_rew_sums", "rew_terms_mean"))
    # one run directory; rank 0 alone wrote the checkpoint
    assert a["log_dir"] == b["log_dir"]
    assert [os.path.basename(p) for p in a["written"]] == ["model_2.pt"] and b["written"] == []
    assert sorted(os.listdir(a["log_dir"])) == ["metrics.jsonl", "model_2.pt"]
    if point is CURRICULUM:
        # the curriculum widened on episodes that ended on one rank's envs
        # alone and on both ranks', and the ranks hold the single process's range
        assert [True, False] in widened and [True, True] in widened, widened
        for v in views:
            assert same_bits(v["cmd_x_range"], carry.env_state.cmd_x_range)
        assert float(carry.env_state.cmd_x_range[1]) > registry.get_cfgs(task)[0] \
            .commands.ranges.lin_vel_x[1]


# ---------------------------------------------------------------------------
# the CLI


def test_train_mesh_at_world_one_gives_the_same_bits(tmp_path, small_cfgs):
    small_cfgs(SMALL)
    argv = ["--task", "humanoid_ppo", "--device", "cpu", "--num-envs", "8",
            "--max-iterations", "1"]
    plain, carry = train.main([*argv, "--log-root", str(tmp_path / "plain")],
                              log_fn=lambda *a: None)
    meshed, mcarry = train.main([*argv, "--mesh", "--log-root", str(tmp_path / "mesh")],
                                log_fn=lambda *a: None)
    assert not torch.distributed.is_initialized()       # the group it made is gone
    assert meshed.shard == mesh.EnvShard(0, 1, 0, 8, 8)
    for (n, p), q in zip(plain.net.named_parameters(), meshed.net.parameters()):
        assert same_bits(p.detach(), q.detach()), n
    assert all(same_bits(x, y) for xs, ys in ((plain.opt.mu, meshed.opt.mu),
                                              (plain.opt.nu, meshed.opt.nu))
               for x, y in zip(xs, ys))
    assert same_bits(plain.opt.lr, meshed.opt.lr)
    for f, x, y in zip(carry.env_state._fields, carry.env_state, mcarry.env_state):
        if f != "phys" and x is not None:
            assert same_bits(x, y), f
    for x, y in zip(carry.env_state.phys, mcarry.env_state.phys):
        assert same_bits(x, y)
    assert same_bits(carry.obs, mcarry.obs) and same_bits(carry.critic_obs, mcarry.critic_obs)


def test_multihost_needs_the_launcher(monkeypatch):
    for var in dist.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        train.main(["--device", "cpu", "--mesh", "--multihost"])
    with pytest.raises(ValueError, match="--mesh"):
        train.main(["--device", "cpu", "--multihost"])
    with pytest.raises(RuntimeError, match="launcher"):
        sweep.main(["--spec", "{}", "--device", "cpu", "--multihost"])


def test_train_mesh_alone_starts_a_rank_per_card(monkeypatch):
    """Launched alone on several cards, train --mesh starts one rank of the
    same command per card and returns nothing of its own."""
    for var in dist.LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    started = []
    monkeypatch.setattr(dist, "launch", lambda world, args, **kw: started.append((world, args)))
    argv = ["--task", "humanoid_ppo", "--num-envs", "48", "--mesh"]
    assert train.main(argv) == (None, None)
    assert started == [(3, ["-m", "humanoid_tpu_torch.scripts.train", *argv])]


def test_launch_stops_every_rank_when_one_fails(tmp_path):
    """A rank that fails ends the launch at once, the others killed; so
    does the timeout; nothing is left running."""
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            "sys.exit(3) if r == 1 and sys.argv[1] == 'fail' else time.sleep(60)")
    for how, match in (("fail", r"rank\(s\) \[1\] failed \(exit codes \[3\]\)"),
                       ("hang", "did not end within 2")):
        with pytest.raises(RuntimeError, match=match):
            dist.launch(2, ["-c", code, how], timeout=2 if how == "hang" else 60,
                        log_dir=str(tmp_path / how))


def test_backend_rule():
    assert dist.backend_for("cpu", 4)[0] == "gloo"
    cards = torch.cuda.device_count()
    assert dist.backend_for("cuda", cards + 1)[0] == "gloo"       # ranks share a card
    if cards:
        assert dist.backend_for("cuda", cards)[0] == "nccl"


# ---------------------------------------------------------------------------
# sweep (tests/test_sweep.py's checks on the port's functions) and
# bench_scaling


def test_sweep_grid_cross_product():
    spec = {"a": [1, 2], "b": ["x", "y", "z"]}
    grid = list(sweep._expand_grid(spec))
    assert len(grid) == 6 and {"a": 2, "b": "z"} in grid
    assert grid == list(ref_expand_grid(spec))


def test_sweep_apply_point_nested_and_shared():
    point = {"seed": 7, "rewards.course_ratio": 1.001, "algorithm.num_learning_epochs": 3,
             "commands.ranges.lin_vel_x": [-0.5, 1.0]}
    env_cfg, train_cfg = tcfg.XBotLCfg(), tcfg.XBotLCfgPPO()
    e2, t2 = sweep.apply_point(env_cfg, train_cfg, point)
    assert e2.seed == 7 and t2.seed == 7
    assert e2.rewards.course_ratio == 1.001
    assert t2.algorithm.num_learning_epochs == 3
    assert e2.commands.ranges.lin_vel_x == (-0.5, 1.0)
    assert env_cfg.seed != 7 and train_cfg.algorithm.num_learning_epochs == 2
    je, jt = ref_apply_point(jcfg.XBotLCfg(), jcfg.XBotLCfgPPO(), point)
    assert (je.seed, jt.seed, je.rewards.course_ratio, jt.algorithm.num_learning_epochs,
            je.commands.ranges.lin_vel_x) == (e2.seed, t2.seed, e2.rewards.course_ratio,
                                               t2.algorithm.num_learning_epochs,
                                               e2.commands.ranges.lin_vel_x)
    assert sweep._coerce(env_cfg.commands.ranges, "lin_vel_x", [1, 2]) == ref_coerce(
        jcfg.XBotLCfg().commands.ranges, "lin_vel_x", [1, 2])


def test_sweep_apply_point_unknown_path():
    with pytest.raises(KeyError):
        sweep.apply_point(tcfg.XBotLCfg(), tcfg.XBotLCfgPPO(), {"nope.x": 1})


def test_sweep_two_points(tmp_path, small_cfgs):
    small_cfgs({"runner.num_steps_per_env": 4})
    spec = json.dumps({"seed": [1, 2]})
    records = sweep.main(["--spec", spec, "--num-envs", "8", "--max-iterations", "1",
                          "--log-root", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "sweep_results.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["point"] for r in lines] == [{"seed": 1}, {"seed": 2}] == \
        [r["point"] for r in records]
    for r in lines:
        assert os.path.isfile(r["policy"]) and r["policy"].endswith("policy_final.npz")
        assert r["iterations"] == 1 and np.isfinite(r["mean_episode_length"])
        with np.load(r["policy"]) as z:
            assert np.isfinite(z["actor_w0"]).all()
    assert lines[0]["run_dir"] != lines[1]["run_dir"]
    assert all(r["gate_passed"] is None for r in lines)      # no --eval-gate


def test_bench_scaling_on_cpu_ranks(capsys):
    rows = bench_scaling.main(["--device", "cpu", "--devices", "1", "2", "--envs-per-device",
                               "8", "--steps", "2", "--warmup", "0", "--iters", "1",
                               "--timeout", str(TIMEOUT)])
    assert [(r["devices"], r["envs"], r["backend"]) for r in rows] == [(1, 8, "gloo"),
                                                                        (2, 16, "gloo")]
    assert all(np.isfinite(r["iter_s"]) and r["env_steps_per_sec"] > 0 for r in rows)
    table = capsys.readouterr().out
    assert "| 1 | 8 |" in table and "| 2 | 16 |" in table
