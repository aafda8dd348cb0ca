"""``CategoryVocab.encode`` (``gbrl_tpu_torch/common/utils.py``): the
batch's table lookup and its per-feature fallback against a plain
per-feature dict encoder written from the vocabulary's rule.

The rule: a value's key is its UTF-8 bytes cut to 128 (trailing NULs
dropped, as a numpy ``S128`` cell drops them); a batch's unseen keys get
new codes per feature in their sorted order when growing, and -1 when
frozen; the codes added are counted as ``vocab.new_codes``.  Each case
holds codes, maps (contents and insertion order) and that count against
the plain encoder, and that every cell is counted once as ``vocab.hit`` or
``vocab.miss``; the last test reads those counters over DoorKey
rollouts."""
import copy

import numpy as np
import pytest

from bench_port.envs import minigrid as M
from gbrl_tpu_torch.common.utils import CategoryVocab, preprocess_features
from gbrl_tpu_torch.learners.gbt_learner import GBTLearner
from gbrl_tpu_torch.rl.buffers import RolloutBuffer
from gbrl_tpu_torch.rl.ppo import PPO
from gbrl_tpu_torch.utils import profiling


class PlainVocab:
    """The vocabulary's rule, one cell at a time."""

    def __init__(self, n_features):
        self.maps = [dict() for _ in range(n_features)]

    @staticmethod
    def key(value) -> bytes:
        s = value.decode("ascii") if isinstance(value, bytes) else str(value)
        return s.encode("utf-8")[:128].rstrip(b"\x00")

    def encode(self, rows, grow):
        """rows: [N][F] values -> (codes [N, F] i32, codes added)."""
        keys = [[self.key(v) for v in row] for row in rows]
        added = 0
        if grow:
            for f, m in enumerate(self.maps):
                for k in sorted({row[f] for row in keys} - m.keys()):
                    m[k] = len(m)
                    added += 1
        codes = np.array([[self.maps[f].get(k, -1) for f, k in enumerate(row)]
                          for row in keys], dtype=np.int32)
        return codes.reshape(len(rows), len(self.maps)), added


def _counts():
    c = profiling.counters()
    return np.array([c.get(k, 0) for k in ("vocab.new_codes", "vocab.hit",
                                            "vocab.miss")])


def _check(vocab, plain, raw, grow=True, values=None):
    """Encode ``raw`` through ``preprocess_features`` with ``vocab`` and its
    values (``values``, else ``raw``'s cells) with ``plain``; returns the
    [new_codes, hit, miss] counts the call made."""
    before = _counts()
    _, cat = preprocess_features(raw)
    got = vocab.encode(cat, grow=grow)
    counted = _counts() - before
    want, added = plain.encode(np.asarray(raw).tolist() if values is None
                               else values, grow)
    np.testing.assert_array_equal(got, want)
    assert [list(m.items()) for m in vocab.maps] == \
        [list(m.items()) for m in plain.maps]
    assert counted[0] == added
    assert counted[1] + counted[2] == cat.size
    return counted


def _doorkey_batches(n_envs, steps, seed):
    env = M.make(n_envs)
    obs, _ = env.reset(seed=seed)
    rng = np.random.default_rng(seed)
    out = [obs]
    for _ in range(steps):
        out.append(env.step(M.random_actions(rng, n_envs))[0])
    return out


def _random_batch(rng, pool, n, f):
    return np.array([[pool[i] for i in row]
                     for row in rng.integers(0, len(pool), size=(n, f))])


def _case_doorkey():
    vocab, plain = CategoryVocab(M.OBS_DIM), PlainVocab(M.OBS_DIM)
    hits = [_check(vocab, plain, obs)[1]
            for obs in _doorkey_batches(16, 256, 3)]
    assert hits[0] == 0 and hits[-1] > 0


def _case_random_growth():
    rng = np.random.default_rng(1)
    alphabet = list("abcxyz_") + ["é", "ß", "中", "😀"]
    pool = [""]
    vocab, plain = CategoryVocab(5), PlainVocab(5)
    for i in range(12):
        pool += ["".join(rng.choice(alphabet, size=rng.integers(1, 20)))
                 for _ in range(4)]
        batch = _random_batch(rng, pool, int(rng.integers(1, 40)), 5)
        if i == 5:
            batch = batch.astype(batch.dtype.newbyteorder(">"))
        if i == 6:
            batch = batch[::2]
        _check(vocab, plain, batch, grow=bool(i % 3))


def _case_frozen():
    vocab, plain = CategoryVocab(3), PlainVocab(3)
    _check(vocab, plain, np.array([["a", "b", "中"], ["a", "c", "é"]]))
    counted = _check(vocab, plain, np.array([["a", "zz", "中"],
                                             ["q", "c", "中文"]]), grow=False)
    assert counted[2] == 3       # "zz", "q" and "中文" are unseen: -1
    counted = _check(vocab, plain, np.array([["a", "b", "é"]]), grow=False)
    assert counted[2] == 0


def _case_long_and_multibyte():
    vocab, plain = CategoryVocab(2), PlainVocab(2)
    x127 = "x" * 127
    # 129 UTF-8 bytes each, equal once cut to 128: one code
    _check(vocab, plain, np.array([[x127 + "é", "a" * 40],
                                   [x127 + "è", "a" * 41]]))
    # 33 four-byte characters are cut to the first 32: the key of a
    # 32-character cell, which the table serves
    _check(vocab, plain, np.array([["😀" * 33, "b"]]))
    counted = _check(vocab, plain, np.array([["😀" * 32, "a"]]))
    assert counted[1] == 1       # "😀" * 32 hits, the new "a" misses
    _check(vocab, plain, np.array([["x" * 31 + "é", "a" * 40],
                                   [x127 + "ê", "😀" * 32]]), grow=False)
    _check(vocab, plain, np.array([["é" * 64, "a\x00b"], ["ab", "a"]]))


def _case_object_and_bytes():
    vocab, plain = CategoryVocab(2), PlainVocab(2)
    obj = np.array([[1.5, "red", "é"], [2.0, "blue", ""],
                    [3.0, "red", "ab\x00"]], dtype=object)
    cats = [row[1:] for row in obj.tolist()]
    _check(vocab, plain, obj, values=cats)
    counted = _check(vocab, plain, obj[::-1], values=cats[::-1])
    assert counted[2] == 0
    by = np.array([[b"red", b"green"], [b"a" * 40, b"blue"]])
    _check(vocab, plain, by)
    _check(vocab, plain, by, grow=False)
    _check(vocab, plain, (None, np.array([["red", "green"]])),
           values=[["red", "green"]])


def _case_from_state():
    rng = np.random.default_rng(2)
    pool = ["a", "bb", "é", "中文", "x" * 33]
    vocab, plain = CategoryVocab(4), PlainVocab(4)
    for _ in range(3):
        _check(vocab, plain, _random_batch(rng, pool, 8, 4))
    loaded = CategoryVocab.from_state(vocab.to_state())
    plain = copy.deepcopy(plain)
    pool += ["new", "ünï"]
    for _ in range(3):
        _check(loaded, plain, _random_batch(rng, pool, 8, 4))
    # codes written into the maps directly (the reference format's import)
    for m in (loaded.maps[0], plain.maps[0]):
        m[b"zz"] = len(m)
    for m in (loaded.maps[1], plain.maps[1]):     # keys no cell canonicalises to
        m[b"q\x00"] = len(m)
        m[b"\xff"] = len(m)
    counted = _check(loaded, plain, np.array([["zz", "q", "a", "a"]]))
    assert counted[2] == 1
    # one map replaced by a larger one with other codes
    for v in (loaded, plain):
        v.maps[2] = {b"x" * 33: 0, b"a": 1, "中文".encode(): 2, b"bb": 3,
                     "é".encode(): 4, b"new": 5, "ünï".encode(): 6,
                     b"extra": 7}
    counted = _check(loaded, plain, np.array([["zz", "q", "a", "bb"],
                                              ["a", "a", "中文", "a"]]))
    assert counted[2] == 0
    for v in (loaded, plain):                    # a map that lost a value
        del v.maps[3][b"a"]
    counted = _check(loaded, plain, np.array([["zz", "q", "a", "a"]]))
    assert counted[2] == 1
    # maps replaced by maps of the same sizes, with the codes reversed
    loaded.maps = [{k: len(m) - 1 - c for k, c in m.items()}
                   for m in loaded.maps]
    plain.maps = [dict(m) for m in loaded.maps]
    counted = _check(loaded, plain, np.array([["zz", "q", "a", "bb"]]))
    assert counted[2] == 0


def _case_copied_learner():
    lr = GBTLearner(M.OBS_DIM, 2, dict(max_depth=2, grow_policy="greedy"),
                    dict(algo="SGD", init_lr=0.1, start_idx=0, stop_idx=2),
                    device="cpu")
    lr.reset()
    lr.set_feature_mapping(np.zeros(M.OBS_DIM, bool))
    batches = _doorkey_batches(4, 40, 7)
    plain = PlainVocab(M.OBS_DIM)
    for obs in batches[:20]:
        _check(lr.vocab, plain, obs)
    lr_copy = copy.copy(lr)
    assert lr_copy.vocab is not lr.vocab
    plain_copy = copy.deepcopy(plain)
    for obs in batches[20:]:
        _check(lr_copy.vocab, plain_copy, obs)
    _check(lr.vocab, plain, batches[-1])


CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_doorkey, _case_random_growth, _case_frozen,
    _case_long_and_multibyte, _case_object_and_bytes, _case_from_state,
    _case_copied_learner)}


@pytest.mark.parametrize("case", list(CASES))
def test_encode_matches_plain_rule(case):
    CASES[case]()


def test_doorkey_rollout_counts_hits():
    """An empty vocabulary's first batch misses in every cell; a rollout
    that replays a warm-up rollout's observations hits in every cell."""
    first = _doorkey_batches(16, 0, 4)[0]
    vocab = CategoryVocab(M.OBS_DIM)
    before = _counts()
    vocab.encode(preprocess_features(first)[1], grow=True)
    distinct = sum(len(set(col)) for col in first.T.tolist())
    assert list(_counts() - before) == [distinct, 0, first.size]

    agent = PPO(M.make(16), tree_struct=dict(max_depth=2,
                                             grow_policy="greedy"),
                n_steps=32, batch_size=256, device="cpu")
    lr = agent.model.learner
    rows = (agent.n_steps + 1) * agent.n_envs
    counted = []
    for _ in range(2):
        obs, _ = agent.env.reset(seed=4)
        buf = RolloutBuffer(agent.n_steps, agent.n_envs, 0, agent.gamma,
                            agent.gae_lambda, lr.cfg.n_cat_features)
        before = _counts()
        agent.collect_rollout(buf, obs, np.zeros(agent.n_envs, np.float32),
                              np.random.default_rng(4))
        counted.append(_counts() - before)
    warm, replay = counted
    assert warm[1] + warm[2] == rows * M.OBS_DIM and warm[2] >= first.size
    assert list(replay) == [0, rows * M.OBS_DIM, 0]
