"""PPO on categorical observations through the port's fused update
(``rl/ppo.py``, ``rl/jit_update.py``) on the benchmark's MiniGrid
DoorKey-8x8 (``bench_port/envs/minigrid.py``).

On the CPU: the env against a literal transcription of MiniGrid's grid
rules (slice, ``rotate_left``, ``process_vis``, ``encode``) on random play,
seeded resets, a hand-built door-and-key state; the rollout's codes
against the plain reference's vocabulary rule; the fused update on codes
against the plain reference (``bench_port/reference/ppo_categorical.py``)
tree for tree; its first tree against ``learner.step`` on the minibatch
given as strings, and its first trees against the JAX package's
``learner.step`` on the same strings and gradients; the mirror on codes against ``learner.predict`` on the
strings; the refusals.  On the card (marked ``cuda``, skips without one):
the update's graph replays bit-equal to its body called plainly:
``python -m pytest tests/test_torch_ppo_categorical.py -q -m cuda
--noconftest``."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port.envs import minigrid as M
from bench_port.reference import ppo_categorical as R
from gbrl_tpu_torch.parallel.sharded import Mesh
from gbrl_tpu_torch.parallel.sharded_rl import sharded_ppo_update
from gbrl_tpu_torch.rl import graphs as G
from gbrl_tpu_torch.rl import jit_update as JU
from gbrl_tpu_torch.rl.buffers import RolloutBuffer
from gbrl_tpu_torch.rl.ppo import PPO
from gbrl_tpu_torch.utils import profiling


# ------------------------------------------------ MiniGrid, transcribed
def _see_behind(c):
    return c not in (M.WALL, M.DOOR_LOCKED, M.DOOR_CLOSED)


def _literal_view(grid, pos, d, carrying):
    """gen_obs_grid + process_vis + encode of MiniGrid, one env, cells as
    the env's ids; grid [8, 8] (x, y), None-as-EMPTY."""
    V = M.VIEW
    ax, ay = pos
    topX, topY = {0: (ax, ay - V // 2), 1: (ax - V // 2, ay),
                  2: (ax - V + 1, ay - V // 2),
                  3: (ax - V // 2, ay - V + 1)}[d]
    g = [[M.WALL] * V for _ in range(V)]          # g[i][j], i = x
    for j in range(V):
        for i in range(V):
            x, y = topX + i, topY + j
            if 0 <= x < M.SIZE and 0 <= y < M.SIZE:
                g[i][j] = int(grid[x, y])
    for _ in range(d + 1):                         # rotate_left
        n = [[None] * V for _ in range(V)]
        for i in range(V):
            for j in range(V):
                n[j][V - 1 - i] = g[i][j]
        g = n
    mask = np.zeros((V, V), bool)
    mask[V // 2, V - 1] = True
    for j in reversed(range(V)):
        for i in range(V - 1):
            if not mask[i, j] or not _see_behind(g[i][j]):
                continue
            mask[i + 1, j] = True
            if j > 0:
                mask[i + 1, j - 1] = mask[i, j - 1] = True
        for i in reversed(range(1, V)):
            if not mask[i, j] or not _see_behind(g[i][j]):
                continue
            mask[i - 1, j] = True
            if j > 0:
                mask[i - 1, j - 1] = mask[i, j - 1] = True
    g[V // 2][V - 1] = M.KEY if carrying else M.EMPTY
    return np.array([[g[i][j] if mask[i, j] else M.UNSEEN
                      for j in range(V)] for i in range(V)]).reshape(-1)


def _state(env, e):
    return (env.grid[e, M.PAD:M.PAD + M.SIZE, M.PAD:M.PAD + M.SIZE].copy(),
            tuple(env.pos[e]), int(env.dir[e]), bool(env.carrying[e]))


def _literal_step(grid, pos, d, carrying, a, steps):
    """MiniGridEnv.step for DoorKey's objects: (grid, pos, dir, carrying,
    reward, terminated)."""
    fx, fy = pos[0] + M.DX[d], pos[1] + M.DY[d]
    fwd = grid[fx, fy]
    reward, term = 0.0, False
    if a == M.LEFT:
        d = (d - 1) % 4
    elif a == M.RIGHT:
        d = (d + 1) % 4
    elif a == M.FORWARD:
        if fwd in (M.EMPTY, M.DOOR_OPEN, M.GOAL):
            pos = (fx, fy)
        if fwd == M.GOAL:
            term, reward = True, 1 - 0.9 * (steps / M.MAX_STEPS)
    elif a == M.PICKUP:
        if fwd == M.KEY and not carrying:
            carrying, grid[fx, fy] = True, M.EMPTY
    elif a == M.DROP:
        if fwd == M.EMPTY and carrying:
            carrying, grid[fx, fy] = False, M.KEY
    elif a == M.TOGGLE:
        if fwd == M.DOOR_LOCKED and carrying:
            grid[fx, fy] = M.DOOR_OPEN
        elif fwd == M.DOOR_CLOSED:
            grid[fx, fy] = M.DOOR_OPEN
        elif fwd == M.DOOR_OPEN:
            grid[fx, fy] = M.DOOR_CLOSED
    return grid, pos, d, carrying, reward, term


def _scripted_actions(env, rng):
    """Random play that mostly picks up a key and toggles a door in front,
    so that keys are carried and doors opened within a short test."""
    n = env.num_envs
    e = np.arange(n)
    fwd = env.grid[e, env.pos[:, 0] + M.DX[env.dir] + M.PAD,
                   env.pos[:, 1] + M.DY[env.dir] + M.PAD]
    a = rng.choice(M.N_ACTIONS, n, p=[.2, .2, .45, .04, .04, .04, .03])
    keen = rng.random(n) < 0.8
    a = np.where(keen & (fwd == M.KEY), M.PICKUP, a)
    return np.where(keen & np.isin(fwd, (M.DOOR_LOCKED, M.DOOR_CLOSED)),
                    M.TOGGLE, a)


def test_env_against_minigrid_rules():
    env = M.make(6)
    obs, _ = env.reset(seed=3)
    rng = np.random.default_rng(4)
    opened = carried = 0
    for _ in range(400):
        want = []
        for e in range(env.num_envs):
            st = _state(env, e)
            assert (obs[e, :49] == M.CELLS[_literal_view(*st)]).all()
            assert obs[e, 49] == str(st[2])
            want.append(st)
        acts = _scripted_actions(env, rng)
        was_reset = env.autoreset.copy()
        steps = env.steps.copy()
        obs, rew, term, trunc, _ = env.step(acts)
        for e in range(env.num_envs):
            if was_reset[e]:
                assert rew[e] == 0 and not term[e] and not trunc[e]
                continue
            g, p, d, c, r, t = _literal_step(*want[e], acts[e], steps[e] + 1)
            assert (p, d, c) == (tuple(env.pos[e]), int(env.dir[e]),
                                 bool(env.carrying[e]))
            assert (env.grid[e, M.PAD:M.PAD + 8, M.PAD:M.PAD + 8] == g).all()
            assert rew[e] == pytest.approx(r) and term[e] == t
            opened += int((g == M.DOOR_OPEN).any())
            carried += int(c)
    assert opened and carried


def test_env_seeded_reset_and_layout():
    a, _ = M.make(8).reset(seed=11)
    b = M.make(8)
    ob, _ = b.reset(seed=11)
    assert (a == ob).all()
    assert not (M.make(8).reset(seed=12)[0] == a).all()
    for e in range(8):
        g = b.grid[e, M.PAD:M.PAD + 8, M.PAD:M.PAD + 8]
        split = int(np.flatnonzero((g[:, 1:7] != M.EMPTY).all(axis=1)
                                   & (np.arange(8) > 0) & (np.arange(8) < 7)
                                   )[0])
        assert 2 <= split < 6
        assert g[6, 6] == M.GOAL
        assert (g[split] == M.DOOR_LOCKED).sum() == 1
        assert 1 <= int(np.flatnonzero(g[split] == M.DOOR_LOCKED)[0]) < 6
        kx, ky = np.argwhere(g == M.KEY)[0]
        assert 1 <= kx < split and 1 <= ky < 7
        assert 1 <= b.pos[e, 0] < split and tuple(b.pos[e]) != (kx, ky)


def test_env_hand_built_door_and_key():
    """Agent at (2, 3) looking right at a locked door in column 3 with the
    key carried: the view, the toggle that unlocks and opens the door, the
    walk through it and the goal's reward."""
    env = M.make(1)
    env.reset(seed=0)
    g = np.full((8, 8), M.EMPTY)
    g[0, :] = g[-1, :] = g[:, 0] = g[:, -1] = M.WALL
    g[3, :] = M.WALL
    g[3, 3] = M.DOOR_LOCKED
    g[6, 6] = M.GOAL
    env.grid[0, M.PAD:M.PAD + 8, M.PAD:M.PAD + 8] = g
    env.pos[0], env.dir[0], env.carrying[0] = (2, 3), 0, True
    view = M.CELLS[env.cell_ids()[0]].reshape(7, 7)    # view[x, y]
    assert view[3, 6] == "key_yellow_none"             # what it carries
    assert view[3, 5] == "door_yellow_locked"          # the door in front
    assert view[3, 4] == "unseen_none_none"            # hidden behind it
    assert view[2, 6] == "empty_none_none"             # (2, 2) on its left
    assert view[0, 6] == "wall_grey_none"              # (2, 0), the wall
    obs, r, t, _, _ = env.step([M.TOGGLE])
    assert obs[0, 7 * 3 + 5] == "door_yellow_open" and r[0] == 0
    assert obs[0, 7 * 3 + 4] == "empty_none_none"      # now seen through
    for a in (M.FORWARD, M.FORWARD, M.FORWARD, M.FORWARD, M.RIGHT,
              M.FORWARD, M.FORWARD):
        obs, r, t, _, _ = env.step([a])
    assert tuple(env.pos[0]) == (6, 5) and not t[0]
    assert obs[0, 7 * 3 + 5] == "goal_green_none"
    obs, r, t, _, _ = env.step([M.FORWARD])
    assert t[0] and r[0] == pytest.approx(1 - 0.9 * 9 / 640)
    obs, r, t, tr, _ = env.step([M.FORWARD])           # next-step reset
    assert r[0] == 0 and not t[0] and not tr[0] and env.steps[0] == 0


# ------------------------------------------------------ the fused update
def _agent(depth, n_envs=2, n_steps=16, batch=16, **kw):
    return PPO(M.make(n_envs), tree_struct=dict(
        max_depth=depth, n_bins=256, min_data_in_leaf=0, par_th=2,
        grow_policy="greedy"), n_steps=n_steps, batch_size=batch,
        n_epochs=2, device="cpu", **kw)


def _rollout(agent, seed):
    """One mirror-served rollout; the string observations it encoded, in
    order, and its buffer, given advantages and returns (a fresh agent's
    are all 0)."""
    env = agent.env
    obs, _ = env.reset(seed=seed)
    lr = agent.model.learner
    buf = RolloutBuffer(agent.n_steps, agent.n_envs, 0, agent.gamma,
                        agent.gae_lambda, lr.cfg.n_cat_features)
    seen = []
    step = env.step

    def recording_step(a):
        out = step(a)
        seen.append(out[0])
        return out
    env.step = recording_step
    rng = np.random.default_rng(seed)
    agent.collect_rollout(buf, obs, np.zeros(agent.n_envs, np.float32), rng)
    seen.insert(0, obs)
    g = np.random.default_rng(seed + 1)
    buf.advantages = g.normal(size=buf.rewards.shape).astype(np.float32)
    buf.returns = g.normal(size=buf.rewards.shape).astype(np.float32)
    return seen, buf


def _data(seen, buf):
    n = buf.n_steps * buf.n_envs
    codes = R.encode_all(seen)
    return dict(obs=np.concatenate(seen[:buf.n_steps]),
                codes=np.concatenate(codes[:buf.n_steps]),
                actions=buf.actions.reshape(n),
                old_logp=buf.log_probs.reshape(n).astype(np.float64),
                adv=buf.advantages.reshape(n).astype(np.float64),
                ret=buf.returns.reshape(n).astype(np.float64),
                valid=1.0 - buf.dones.reshape(n).astype(np.float64))


def _cfg(depth):
    return dict(n_actions=7, output_dim=8, tree_struct=dict(max_depth=depth),
                params=dict(split_score_func="cosine"),
                hyper=dict(policy_lr=0.17, value_lr=0.01, clip_range=0.2,
                           ent_coef=0.0, vf_coef=0.5,
                           normalize_advantage=True))


def _tree(ens, t):
    return {f: getattr(ens, f)[t] for f in ("feat", "cat_code", "is_split",
                                            "is_numeric", "leaf_values")}


@pytest.mark.parametrize("depth", [2, 4])
def test_fused_update_matches_reference(depth):
    agent = _agent(depth)
    seen, buf = _rollout(agent, 5)
    data = _data(seen, buf)
    assert (data["codes"] == buf.flat_codes()).all()     # the vocab rule
    lr = agent.model.learner
    before = copy.copy(lr)
    counts = profiling.counters()
    agent.update([buf], np.random.default_rng(9))
    assert profiling.counters().get("vocab.new_codes", 0) == counts.get(
        "vocab.new_codes", 0)                             # update adds none
    plan = R.minibatch_plan(np.random.default_rng(9), len(data["codes"]), 2,
                            16)
    k = 3
    follow = [{f: v.numpy() for f, v in _tree(lr.ens, t).items()}
              for t in range(k)]
    ref = R.first_steps(data, plan, _cfg(depth), k, follow=follow)
    for t, rt in enumerate(ref["trees"]):
        got = _tree(lr.ens, t)
        assert not got["is_numeric"].any()
        assert (got["feat"].long() == rt["feat"]).all(), t
        assert (got["cat_code"].long() == rt["cat_code"]).all(), t
        assert (got["is_split"] == rt["is_split"]).all(), t
        assert torch.allclose(got["leaf_values"].double(), rt["leaf_values"],
                              rtol=1e-4, atol=1e-5), t
        assert got["is_split"].any()
    # the predictions after k trees over the rollout, through the learner
    pol, val = lr.predict(data["obs"], requires_grad=False, stop_idx=k)
    want = ref["preds"][k].numpy()
    assert np.allclose(pol.numpy(), want[:, :7], atol=1e-5)
    assert np.allclose(val.numpy(), want[:, 7], atol=1e-5)
    # the first tree is learner.step's on the minibatch given as strings
    idx = plan[0]
    hp = JU.PPOHyper(n_actions=7, clip_range=0.2, ent_coef=0.0, vf_coef=0.5,
                     normalize_advantage=True, policy_clip=0.0,
                     value_clip=0.0)
    t = {c: torch.as_tensor(data[c][idx]) for c in ("old_logp", "adv",
                                                    "ret", "valid")}
    g = JU.ppo_minibatch_grads(
        hp, torch.zeros((len(idx), 8)), torch.as_tensor(data["actions"][idx]),
        t["old_logp"].float(), t["adv"].float(), t["ret"].float(),
        t["valid"].float())
    assert (t["valid"] == 1).all()
    before.step(data["obs"][idx], g)
    for f, v in _tree(before.ens, 0).items():
        assert torch.equal(v, _tree(lr.ens, 0)[f]), f
    # ... and its first k trees gbrl_tpu's learner.step's, each on the
    # strings of its minibatch and the gradients at its own predictions
    from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
    jl = _jax_learner(lr, seen)
    for u in range(k):
        idx = plan[u]
        # (its predict's cache key cannot hash a numeric block of width 0)
        P = torch.as_tensor(np.array(jl.predict_async(data["obs"][idx])))
        g = JU.ppo_minibatch_grads(
            hp, P, torch.as_tensor(data["actions"][idx]),
            *(torch.as_tensor(data[c][idx]).float()
              for c in ("old_logp", "adv", "ret", "valid")))
        jl.step(data["obs"][idx], g.numpy())
    want = j_to_numpy(jl.ens)
    for t in range(k):
        got = _tree(lr.ens, t)
        for f in ("feat", "cat_code", "is_split", "is_numeric"):
            assert (got[f].numpy() == want[f][t]).all(), (t, f)
        np.testing.assert_allclose(got["leaf_values"].numpy(),
                                   want["leaf_values"][t], rtol=1e-5,
                                   atol=1e-6, err_msg=str(t))


def _jax_learner(lr, seen):
    """gbrl_tpu's shared actor-critic learner with the port learner's
    trees' settings, its vocabulary grown over the observation batches
    in the order the rollout encoded them (imported here: the card's
    tests run without JAX)."""
    from gbrl_tpu.learners.actor_critic_learner import \
        SharedActorCriticLearner as JLearner
    jl = JLearner(lr.input_dim, lr.output_dim, lr.tree_struct,
                  *lr.optimizers, params=lr.params, device="cpu")
    jl.reset()
    jl.set_feature_mapping(np.zeros(lr.input_dim, bool))
    for obs in seen:
        jl.vocab.encode(obs, grow=True)
    assert jl.vocab.maps == lr.vocab.maps
    return jl


def test_mirror_on_codes_matches_predict():
    agent = _agent(3, n_envs=3, n_steps=16, batch=24)
    seen, buf = _rollout(agent, 2)
    agent.update([buf], np.random.default_rng(1))
    mirror = agent._get_mirror()
    mirror.sync()
    obs = np.concatenate(seen)
    x, codes = agent._features(obs)
    assert x.shape == (len(obs), 0)
    got = mirror.predict(x, codes)
    pol, val = agent.model.learner.predict(obs, requires_grad=False)
    assert np.allclose(got[:, :7], pol.numpy(), atol=1e-6)
    assert np.allclose(got[:, 7], val.numpy(), atol=1e-6)
    assert agent.model.learner.get_num_trees() == 4


def test_learn_runs_on_codes():
    agent = _agent(2, n_steps=8, batch=8)
    agent.learn(2 * 8 * 2, seed=1)
    lr = agent.model.learner
    assert agent.curve[-1]["trees"] == lr.get_num_trees() == 8
    assert lr.cfg.n_cat_features == 50 and lr.cfg.n_num_features == 0
    assert agent._buffers[0].codes.shape == (8, 2, 50)
    assert agent._buffers[0].obs.shape == (8, 2, 0)


class _Mixed:
    """DoorKey with a numeric first column (the env's step count): an
    object-valued observation of 1 number and 50 categories."""

    def __init__(self, n):
        self.env = M.make(n)
        self.num_envs = n
        self.single_observation_space = SimpleNamespace(
            shape=(M.OBS_DIM + 1,), dtype=np.dtype(object))
        self.single_action_space = self.env.single_action_space

    def _obs(self, o):
        out = np.empty((self.num_envs, M.OBS_DIM + 1), object)
        out[:, 0] = self.env.steps.astype(float)
        out[:, 1:] = o
        return out

    def reset(self, seed=None):
        o, info = self.env.reset(seed=seed)
        return self._obs(o), info

    def step(self, a):
        o, *rest = self.env.step(a)
        return (self._obs(o), *rest)


def test_learn_runs_on_mixed_observations():
    agent = PPO(_Mixed(2), tree_struct=dict(max_depth=3, n_bins=16,
                                            grow_policy="greedy"),
                n_steps=8, batch_size=8, n_epochs=1, device="cpu")
    agent.learn(16, seed=2)
    lr = agent.model.learner
    assert (lr.cfg.n_num_features, lr.cfg.n_cat_features) == (1, 50)
    assert agent._buffers[0].obs.shape == (8, 2, 1)
    assert lr.get_num_trees() == 2


def test_refusals():
    with pytest.raises(ValueError, match="fused update"):
        _agent(2, jit_update=False)
    agent = _agent(2)
    cfg = agent.model.learner.cfg
    X = torch.zeros((4, 0))
    with pytest.raises(ValueError, match="categorical features"):
        sharded_ppo_update(cfg, None, Mesh(0, 1, torch.device("cpu")), None,
                           X, np.zeros((1, 4), np.int64), [4], *(
                               torch.zeros(4) for _ in range(4)), (),
                           torch.zeros(0))


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_graph_replay_matches_body_on_card(monkeypatch):
    """One update on the card, graph replays against the body called
    plainly on the same inputs: the same trees and entropy trace, bit for
    bit; one capture for the minibatch shape, the rest replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")

    def run(plain):
        G._GRAPHS.clear()
        agent = PPO(M.make(4), n_steps=64, batch_size=64, n_epochs=2,
                    device="cuda")
        seen, buf = _rollout(agent, 7)
        before = dict(profiling.counters())
        with monkeypatch.context() as m:
            if plain:
                m.setattr(G, "run_step", lambda g, key, dev, body: body())
            agent.update([buf], np.random.default_rng(3))
        torch.cuda.synchronize()
        after = profiling.counters()
        graphs = {k: after.get(k, 0) - before.get(k, 0) for k in
                  ("graph.capture", "graph.replay", "graph.eager")}
        return agent.model.learner.ens, graphs
    plain, pc = run(True)
    graph, gc = run(False)
    assert pc == {"graph.capture": 0, "graph.replay": 0, "graph.eager": 0}
    assert gc == {"graph.capture": 1, "graph.replay": 7, "graph.eager": 1}
    for f in ("feat", "cat_code", "is_split", "is_numeric", "leaf_values",
              "counts", "depths", "n_trees"):
        assert torch.equal(getattr(plain, f), getattr(graph, f)), f
    assert int(graph.n_trees) == 8 and bool(graph.is_split[:8].any())
