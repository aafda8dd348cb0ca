"""The SAC train step's boosting body and its CUDA graph (``rl/jit_sac.py``
``_SACGraphs``, ``rl/graphs.py``).

On the CPU: several ``run_sac_train_step`` calls, which run the body the
card captures over its static buffers and working copies, against the same
calls with ``sac_train_step`` swapped for an eager yardstick written here
(the step as it was before the body: every tree appended out of place by
``_boost``), bit for bit, for each Q-form and both tree paths; the card
generator's stream (2 draws a step); a ``write_tree`` that writes nothing
leaves every learner's ensemble as it was (the benchmark's ``unchanged``
fault); the working copies reload for a new agent and after
``_jump_critic_bias`` and never between steps; the benchmark's
``target_step`` records one target sum per critic, its prefix sum.  On
the card (marked ``cuda``, skips without one): graph replay against the
same steps with ``graphs.run_step`` swapped for a plain call, bit for bit,
with the capture, replay and launch counts.  Run the card test on a
machine with an H100:
``python -m pytest tests/test_torch_graph_sac.py -q -m cuda --noconftest``.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gbrl_tpu_torch.ensemble import (FIELDS, ensemble_to_numpy,  # noqa: E402
                                     ensure_capacity)
from gbrl_tpu_torch.ops import fit as FT  # noqa: E402
from gbrl_tpu_torch.ops import kernels as K  # noqa: E402
from gbrl_tpu_torch.rl import SAC  # noqa: E402
from gbrl_tpu_torch.rl import graphs as G  # noqa: E402
from gbrl_tpu_torch.rl import jit_sac as JS  # noqa: E402
from gbrl_tpu_torch.utils import profiling  # noqa: E402

N, A, F, TREES, STEPS = 32, 1, 3, 3, 4
TREE = dict(max_depth=3, n_bins=16, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious")
GRAPH_COUNTS = ("graph.capture", "graph.replay", "graph.eager")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process (the runner's workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agent(qtype: str = "linear", device: str = "cpu") -> SAC:
    """A SAC on Pendulum's spaces whose learners took TREES boosting steps
    on seeded random gradients (the critics on different ones), with room
    for 16 more trees; the target prefix 2 moves every 2 trees."""
    s = SAC(chip_smoke.VecPendulum(2), tree_struct=dict(TREE),
            q_func_type=qtype, actor_lr=0.1, critic_lr=0.1, batch_size=N,
            max_grad_norm=1.0, target_update_interval=2, device=device)
    rng = np.random.default_rng(12)
    for m in [s.actor] + s.critics:
        lr = m.learner
        for _ in range(TREES):
            X = rng.normal(size=(64, F)).astype(np.float32)
            lr.step(X, rng.normal(size=(64, lr.output_dim)).astype(
                np.float32))
        lr.ens = ensure_capacity(lr.ens, TREES + 16)
        lr._rl_host_n_trees = TREES
    for c in s.critics:
        c.target_prefix = 2
    return s


def _batch(rng):
    th = rng.uniform(-np.pi, np.pi, N)
    obs = np.stack([np.cos(th), np.sin(th), rng.normal(size=N) * 2],
                   axis=1).astype(np.float32)
    nth = th + rng.normal(size=N) * 0.1
    next_obs = np.stack([np.cos(nth), np.sin(nth), rng.normal(size=N) * 2],
                        axis=1).astype(np.float32)
    return (obs, rng.uniform(-1, 1, (N, A)).astype(np.float32),
            rng.normal(size=N).astype(np.float32) - 3.0, next_obs,
            (rng.random(N) < 0.1).astype(np.float32),
            np.float32(0.9) ** rng.integers(1, 4, N).astype(np.float32))


def _eager_step(acfg, ccfg, hp, specs, actor_ens, critic_ens, prefixes, obs,
                actions, rewards, next_obs, dones, discs, alpha, feat_w,
                eps_next, eps_cur):
    """The yardstick: the SAC step as it was written before the graph
    body, eager, each tree appended out of place by ``_boost``."""
    actor_specs, critic_specs = specs
    A_ = hp.act_dim
    N_ = obs.shape[0]
    th_next = JS.predict_sgd(acfg, actor_ens, next_obs, actor_specs, 0,
                             actor_ens.capacity)
    na, nlogp = JS.sample_squashed(th_next[:, :A_], th_next[:, A_:],
                                   eps_next)
    tqs = []
    for i, ens in enumerate(critic_ens):
        th_t = JS.predict_sgd(ccfg, ens, next_obs, critic_specs, 0,
                              prefixes[i])
        tqs.append(JS.q_torch(*JS._critic_wb(hp, th_t), na, hp.q_func_type))
    qmin_t = torch.amin(torch.stack(tqs, 0), dim=0)
    y = (rewards + discs * (1.0 - dones)
         * (qmin_t - alpha * nlogp)).detach()
    new_critics, closses = [], []
    for ens in critic_ens:
        theta = JS.predict_sgd(ccfg, ens, obs, critic_specs, 0, ens.capacity)
        p = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            q = JS.q_torch(*JS._critic_wb(hp, p), actions, hp.q_func_type)
            loss = 0.5 * torch.mean((q - y) ** 2)
            (g,) = torch.autograd.grad(loss, p)
        g = JS._clip_blocks(hp, g * N_)
        new_critics.append(JS._boost(ccfg, ens, obs, g, feat_w))
        closses.append(loss.detach())
    theta_a = JS.predict_sgd(acfg, actor_ens, obs, actor_specs, 0,
                             actor_ens.capacity)
    qthetas = [JS.predict_sgd(ccfg, ens, obs, critic_specs, 0, ens.capacity)
               for ens in new_critics]
    p = theta_a.detach().requires_grad_(True)
    with torch.enable_grad():
        a, logp = JS.sample_squashed(p[:, :A_], p[:, A_:], eps_cur)
        qs = [JS.q_torch(*JS._critic_wb(hp, qt), a, hp.q_func_type)
              for qt in qthetas]
        qmin = torch.amin(torch.stack(qs, 0), dim=0)
        aloss = torch.mean(alpha * logp - qmin)
        (ga,) = torch.autograd.grad(aloss, p)
    ga = JS._clip_blocks(hp, ga * N_)
    new_actor = JS._boost(acfg, actor_ens, obs, ga, feat_w)
    stats = dict(critic_loss=torch.mean(torch.stack(closses)),
                 actor_loss=aloss.detach(),
                 logp_mean=torch.mean(logp.detach()))
    return new_actor, tuple(new_critics), stats


def _steps(agent: SAC, k: int, gen: torch.Generator, seed: int = 3) -> list:
    """``k`` ``run_sac_train_step`` calls on seeded batches; each call's
    statistics."""
    rng = np.random.default_rng(seed)
    return [JS.run_sac_train_step(agent, *_batch(rng), gen)
            for _ in range(k)]


def _learners(agent: SAC) -> list:
    return [agent.actor.learner] + [c.learner for c in agent.critics]


def _assert_same_agents(got: SAC, want: SAC):
    """Equal bits in every learner's ensemble, the same host counters,
    target prefixes and temperature."""
    for lg, lw in zip(_learners(got), _learners(want)):
        a, b = ensemble_to_numpy(lg.ens), ensemble_to_numpy(lw.ens)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert lg._rl_host_n_trees == lw._rl_host_n_trees
    assert [c.target_prefix for c in got.critics] == \
        [c.target_prefix for c in want.critics]
    assert torch.equal(got.log_alpha.detach(), want.log_alpha.detach())


class _tree_path:
    def __init__(self, path: str):
        self.k6 = path == "k6"

    def __enter__(self):
        FT._DISABLE_FUSED_TREE = not self.k6

    def __exit__(self, *exc):
        FT._DISABLE_FUSED_TREE = True


def _graph_counts() -> dict:
    c = profiling.counters()
    return {k: c.get(k, 0) for k in GRAPH_COUNTS}


def _sac_sets() -> list:
    return [g for g in G._GRAPHS.values() if isinstance(g, JS._SACGraphs)]


@pytest.mark.parametrize("qtype,path", [("linear", "level"),
                                        ("quadratic", "level"),
                                        ("tanh", "level"),
                                        ("linear", "k6")])
def test_train_steps_match_the_eager_step_on_cpu(qtype, path, monkeypatch):
    """STEPS ``run_sac_train_step`` calls through the body, against the
    same calls with ``sac_train_step`` swapped for the eager yardstick, on
    the same batches and the same generator's noise: every learner's
    ensemble, the statistics, the prefixes (moved at 4 and 6 trees) and
    the temperature, bit for bit; nothing captured off the card."""
    before = _graph_counts()
    with _tree_path(path):
        got = _agent(qtype)
        stats = _steps(got, STEPS, torch.Generator().manual_seed(11))
        want = _agent(qtype)
        with monkeypatch.context() as m:
            m.setattr(JS, "sac_train_step", _eager_step)
            want_stats = _steps(want, STEPS,
                                torch.Generator().manual_seed(11))
    assert stats == want_stats
    _assert_same_agents(got, want)
    assert all(lr._rl_host_n_trees == TREES + STEPS
               and int(lr.ens.n_trees) == TREES + STEPS
               for lr in _learners(got))
    assert [c.target_prefix for c in got.critics] == [6, 6]
    assert _graph_counts() == before


def test_noise_stream_is_two_draws_a_step():
    """The card generator's state after k steps is its state after 2k
    plain ``torch.randn`` draws of [N, A] (``eps_next``, then
    ``eps_cur``), as the benchmark's reference redraws it."""
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    _steps(_agent(), 3, gen)
    twin = torch.Generator().manual_seed(2 ** 31 + 7)
    for _ in range(2 * 3):
        torch.randn((N, A), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_no_op_write_tree_leaves_every_learner_unchanged(monkeypatch):
    """With ``jit_sac.write_tree`` a no-op (the benchmark's ``unchanged``
    fault) no learner's ensemble changes over three steps, though the
    working copies grew: every tree reaches a learner through it."""
    G._GRAPHS.clear()
    agent = _agent()
    before = [ensemble_to_numpy(lr.ens) for lr in _learners(agent)]
    monkeypatch.setattr(JS, "write_tree", lambda ens, tree, idx: ens)
    _steps(agent, 3, torch.Generator().manual_seed(1))
    for lr, arrs in zip(_learners(agent), before):
        for k, v in ensemble_to_numpy(lr.ens).items():
            np.testing.assert_array_equal(v, arrs[k], err_msg=k)
    (g,) = _sac_sets()
    assert [int(w.n_trees) for w in g.work] == [TREES + 3] * 3


def _copied_roles(monkeypatch, g) -> list:
    """Spy on ``Tensor.copy_``: the roles (0 the actor, then the critics)
    whose working copy a copy writes, in order."""
    roles = {getattr(w, f).data_ptr(): i for i, w in enumerate(g.work)
             for f in FIELDS}
    hits = []
    real = torch.Tensor.copy_

    def spy(self, src, *a, **k):
        if self.data_ptr() in roles:
            hits.append(roles[self.data_ptr()])
        return real(self, src, *a, **k)
    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    return hits


def test_working_copies_reload_only_for_new_ensembles(monkeypatch):
    """The working copies reload when a learner's ensemble is not the one
    the last hand-off gave it, and only then: not between steps; the
    critics' after ``_jump_critic_bias`` (a new bias); all three for
    another agent and back.  The steps stay bit-equal to the eager
    yardstick run through the same events."""
    G._GRAPHS.clear()
    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(5)]

    def events(a: SAC, b: SAC, spy=None):
        """A step of ``a``; then, with the copies spied on, another step
        of ``a``, its value jump and a step, a step of ``b``, a step of
        ``a``.  Returns the statistics and the copies of each spied
        step."""
        gen_a, gen_b = (torch.Generator().manual_seed(s) for s in (21, 22))
        for x in batches[:2]:
            a.buffer.add(*x)
        out = [JS.run_sac_train_step(a, *batches[0], gen_a)]
        hits = spy(_sac_sets()[0]) if spy else []
        seen = []
        for x, (agent, gen, jump) in zip(batches[1:], (
                (a, gen_a, False), (a, gen_a, True), (b, gen_b, False),
                (a, gen_a, False))):
            if jump:
                agent._jump_critic_bias()
            n0 = len(hits)
            out.append(JS.run_sac_train_step(agent, *x, gen))
            seen.append(hits[n0:])
        return out, seen

    got = (_agent(), _agent())
    stats, seen = events(*got, spy=lambda g: _copied_roles(monkeypatch, g))
    monkeypatch.undo()
    n = len(FIELDS)
    assert seen == [[], [1] * n + [2] * n, [0] * n + [1] * n + [2] * n,
                    [0] * n + [1] * n + [2] * n], seen
    want = (_agent(), _agent())
    with monkeypatch.context() as m:
        m.setattr(JS, "sac_train_step", _eager_step)
        want_stats, _ = events(*want)
    assert stats == want_stats
    for g_agent, w_agent in zip(got, want):
        _assert_same_agents(g_agent, w_agent)
    G._GRAPHS.clear()


def test_benchmark_target_step_records_each_critics_prefix_sum():
    """The benchmark's ``target_step`` (which wraps ``sac_train_step`` and
    ``predict_sgd``) after a step through the body: one recorded target
    sum per critic, equal to that critic's sum up to its prefix over the
    step's next observations."""
    from bench_port.agents.sac import target_step
    agent = _agent()
    agent._train_gen = torch.Generator().manual_seed(9)
    rng = np.random.default_rng(8)
    for _ in range(3):
        agent.buffer.add(*_batch(rng))
    _steps(agent, 2, agent._train_gen)
    critics = [(c.learner, c.learner.ens, c.target_prefix)
               for c in agent.critics]
    assert [p for _, _, p in critics] == [TREES + 1] * 2   # of TREES + 2
    out = target_step(agent)
    assert len(out["sums"]) == len(agent.critics)
    X = torch.from_numpy(out["obs"])
    for (lr, ens, p), got in zip(critics, out["sums"]):
        want = JS.predict_sgd(lr.cfg, ens, X, lr.specs, 0,
                              torch.tensor(p, dtype=torch.int32))
        np.testing.assert_array_equal(got, want.numpy().astype(np.float64))
    assert all(lr._rl_host_n_trees == TREES + 3 for lr in _learners(agent))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the CUDA kernels "
                    "run only on the card")
    return torch.device("cuda")


def _card_steps(k: int):
    """``k`` steps of a fresh agent on the card from one seeded card
    generator; (the agent, each step's statistics, the launch counts)."""
    agent = _agent(device="cuda")
    K.reset_launch_counts()
    stats = _steps(agent, k, torch.Generator(device="cuda").manual_seed(11))
    torch.cuda.synchronize()
    return agent, stats, dict(K.launch_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["level", "k6"])
def test_sac_graph_replay_matches_eager_on_card(cuda_device, path,
                                                monkeypatch):
    """Graph replay against the same steps with ``graphs.run_step`` swapped
    for a plain call, on the card, over 5 steps: every learner's ensemble,
    the statistics, prefixes and temperature, bit for bit; one capture, a
    replay for every other step; the plain calls' launch counts."""
    G._GRAPHS.clear()
    k = STEPS + 1
    with _tree_path(path):
        with monkeypatch.context() as m:
            m.setattr(G, "run_step",
                      lambda graphs, key, dev, body: body())
            before = _graph_counts()
            plain, plain_stats, plain_counts = _card_steps(k)
            assert _graph_counts() == before
        before = _graph_counts()
        graph, stats, counts = _card_steps(k)
        got = {n: c - before[n] for n, c in _graph_counts().items()}
    assert got == {"graph.capture": 1, "graph.eager": 1,
                   "graph.replay": k - 1}, got
    assert stats == plain_stats
    _assert_same_agents(graph, plain)
    assert counts == plain_counts, (counts, plain_counts)
    G._GRAPHS.clear()
