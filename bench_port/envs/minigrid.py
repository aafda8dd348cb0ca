"""MiniGrid-DoorKey-8x8-v0 for ``n`` envs in numpy, with categorical
observations: each of the 49 cells of the agent's 7 x 7 view is the string
``"<object>_<color>_<state>"`` and the agent's direction is a 50th feature.

Written from the public definition of Farama's MiniGrid
(``minigrid/envs/doorkey.py``, ``minigrid/minigrid_env.py``,
``minigrid/core/grid.py``, ``minigrid/core/world_object.py``); the
chip's machine has neither MiniGrid nor gymnasium.

- ``_gen_grid``: walls around the 8 x 8 grid, the green goal at (6, 6), a
  wall column at ``split`` in [2, 6), the agent at a random cell of the
  left room with a random direction, a locked yellow door in the wall
  column at a row in [1, 6), the yellow key at a random free cell of the
  left room.
- Seven actions: left, right, forward, pickup, drop, toggle, done.  Forward
  moves onto an empty cell, an open door or the goal; pickup takes the key
  in front when nothing is carried; drop puts the carried key on an empty
  cell in front; toggle opens the locked door when the key is carried and
  opens or closes an unlocked one.
- Reaching the goal gives ``1 - 0.9 * steps / max_steps`` and terminates;
  ``max_steps`` = 10 * 8^2 = 640 steps truncate.
- The observation is ``gen_obs_grid`` with ``see_through_walls`` False:
  the view in front of the agent, rotated so that the agent looks up from
  (3, 6); ``process_vis`` hides what walls and closed doors hide; cells
  outside the grid read as walls; the agent's own cell shows what it
  carries (the key, else empty); hidden cells read as unseen.  Cells are
  flattened x-major (feature 7 * x + y, MiniGrid's ``image[x, y]``).
- Next-step autoreset, as ``envs/cartpole.py``: a row that ended is reset
  on the following step, which returns the reset observation, reward 0
  and neither flag.

Where this departs from MiniGrid:

- the strings are this file's (MiniGrid encodes integers):
  ``empty_none_none``, ``wall_grey_none``, ``door_yellow_locked`` /
  ``_closed`` / ``_open``, ``key_yellow_none``, ``goal_green_none``,
  ``unseen_none_none``; the direction is ``"0"`` .. ``"3"``;
- the random draws are a numpy generator's, seeded by ``reset(seed)``, in
  MiniGrid's order (split, agent cell, direction, door row, key cell);
  a cell is drawn uniformly from the free cells, which MiniGrid's
  rejection sampling also gives;
- the mission string is not part of the observation.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

SIZE, VIEW, MAX_STEPS = 8, 7, 640
N_ACTIONS = 7
LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE = range(N_ACTIONS)
(EMPTY, WALL, DOOR_LOCKED, DOOR_CLOSED, DOOR_OPEN, KEY, GOAL,
 UNSEEN) = range(8)
CELLS = np.array(["empty_none_none", "wall_grey_none", "door_yellow_locked",
                  "door_yellow_closed", "door_yellow_open", "key_yellow_none",
                  "goal_green_none", "unseen_none_none"])
DIRECTIONS = np.array(["0", "1", "2", "3"])
SEE_BEHIND = np.array([1, 0, 0, 0, 1, 1, 1, 1], bool)
CAN_OVERLAP = np.array([1, 0, 0, 0, 1, 0, 1, 0], bool)
# DIR_TO_VEC: right, down, left, up
DX = np.array([1, 0, -1, 0])
DY = np.array([0, 1, 0, -1])
# the grid is kept padded with walls, so that every view cell reads inside
PAD = VIEW - 1
OBS_DIM = VIEW * VIEW + 1


def _view_offsets():
    """[4, 7, 7] world offsets (x, y) from the agent of each view cell
    (view[x, y], x-major), per direction: MiniGrid's ``get_view_exts``
    slice turned by ``rotate_left`` direction + 1 times."""
    top = {0: (0, -(VIEW // 2)), 1: (-(VIEW // 2), 0),
           2: (-VIEW + 1, -(VIEW // 2)), 3: (-(VIEW // 2), -VIEW + 1)}
    ox = np.zeros((4, VIEW, VIEW), np.int64)
    oy = np.zeros((4, VIEW, VIEW), np.int64)
    ii, jj = np.meshgrid(np.arange(VIEW), np.arange(VIEW), indexing="ij")
    for d in range(4):
        sx, sy = ii + top[d][0], jj + top[d][1]
        for _ in range(d + 1):              # rotate_left: new[j, H-1-i]
            nx, ny = np.empty_like(sx), np.empty_like(sy)
            nx[jj, VIEW - 1 - ii] = sx
            ny[jj, VIEW - 1 - ii] = sy
            sx, sy = nx, ny
        ox[d], oy[d] = sx, sy
        assert sx[VIEW // 2, VIEW - 1] == 0 and sy[VIEW // 2, VIEW - 1] == 0
    return ox, oy


def _vis_table():
    """``process_vis`` on one row of the view, for every (mask, see-behind)
    pair of 7-bit rows: [2^14] (the row's mask after both sweeps, the marks
    it makes on the row above), each as 7 bits."""
    code = np.arange(1 << (2 * VIEW))
    bit = 1 << np.arange(VIEW)
    mask = (code[:, None] & bit[None]) > 0
    see = ((code[:, None] >> VIEW) & bit[None]) > 0
    up = np.zeros_like(mask)
    for i in range(VIEW - 1):
        m = mask[:, i] & see[:, i]
        mask[:, i + 1] |= m
        up[:, i + 1] |= m
        up[:, i] |= m
    for i in reversed(range(1, VIEW)):
        m = mask[:, i] & see[:, i]
        mask[:, i - 1] |= m
        up[:, i - 1] |= m
        up[:, i] |= m
    return mask, up


OX, OY = _view_offsets()
VIS_MASK, VIS_UP = _vis_table()
BITS = 1 << np.arange(VIEW)


class VecDoorKey:
    """DoorKey-8x8 for ``n`` envs, with the interface PPO reads from a
    gymnasium vector env (``num_envs``, ``single_observation_space`` with
    its ``shape`` and string ``dtype``, ``single_action_space.n``,
    ``reset``, ``step``).  Observations are [n, 50] unicode arrays."""

    def __init__(self, n: int):
        self.num_envs = n
        self.single_observation_space = SimpleNamespace(
            shape=(OBS_DIM,), dtype=CELLS.dtype)
        self.single_action_space = SimpleNamespace(n=N_ACTIONS)
        self.rng = np.random.default_rng()
        side = SIZE + 2 * PAD
        self.grid = np.full((n, side, side), WALL, np.int64)
        self.pos = np.zeros((n, 2), np.int64)       # agent (x, y)
        self.dir = np.zeros(n, np.int64)
        self.carrying = np.zeros(n, bool)
        self.steps = np.zeros(n, np.int64)
        self.autoreset = np.zeros(n, bool)

    # ------------------------------------------------------------- layout
    def _free_cell(self, split: int, taken=None):
        """A uniformly drawn cell of the left room's inside (x in [1,
        split), y in [1, 7)) other than ``taken``."""
        while True:
            x = int(self.rng.integers(1, split))
            y = int(self.rng.integers(1, SIZE - 1))
            if (x, y) != taken:
                return x, y

    def _gen_grid(self, e: int) -> None:
        g = np.full((SIZE, SIZE), EMPTY, np.int64)
        g[0, :] = g[-1, :] = g[:, 0] = g[:, -1] = WALL
        g[SIZE - 2, SIZE - 2] = GOAL
        split = int(self.rng.integers(2, SIZE - 2))
        g[split, :] = WALL
        agent = self._free_cell(split)
        self.dir[e] = int(self.rng.integers(0, 4))
        door = int(self.rng.integers(1, SIZE - 2))
        g[split, door] = DOOR_LOCKED
        key = self._free_cell(split, agent)
        g[key] = KEY
        self.grid[e, PAD:PAD + SIZE, PAD:PAD + SIZE] = g
        self.pos[e] = agent
        self.carrying[e] = False
        self.steps[e] = 0

    # -------------------------------------------------------- observation
    def cell_ids(self) -> np.ndarray:
        """[n, 49] cell ids of each env's view (x-major), hidden cells
        unseen, the agent's cell what it carries."""
        n = self.num_envs
        e = np.arange(n)[:, None, None]
        d = self.dir
        view = self.grid[e, self.pos[:, 0, None, None] + PAD + OX[d],
                         self.pos[:, 1, None, None] + PAD + OY[d]]
        see = SEE_BEHIND[view]                               # [n, x, y]
        mask = np.zeros((n, VIEW, VIEW), bool)
        mask[:, VIEW // 2, VIEW - 1] = True
        for j in reversed(range(VIEW)):
            code = (mask[:, :, j] @ BITS) | ((see[:, :, j] @ BITS) << VIEW)
            mask[:, :, j] = VIS_MASK[code]
            if j > 0:
                mask[:, :, j - 1] |= VIS_UP[code]
        ids = np.where(mask, view, UNSEEN)
        ids[:, VIEW // 2, VIEW - 1] = np.where(self.carrying, KEY, EMPTY)
        return ids.reshape(n, VIEW * VIEW)

    def observe(self) -> np.ndarray:
        return np.concatenate([CELLS[self.cell_ids()],
                               DIRECTIONS[self.dir][:, None]], axis=1)

    # ---------------------------------------------------------------- API
    def reset(self, seed=None):
        self.rng = np.random.default_rng(seed)
        for e in range(self.num_envs):
            self._gen_grid(e)
        self.autoreset[:] = False
        return self.observe(), {}

    def step(self, actions):
        a = np.asarray(actions).reshape(-1)
        n = self.num_envs
        e = np.arange(n)
        fx = self.pos[:, 0] + DX[self.dir] + PAD
        fy = self.pos[:, 1] + DY[self.dir] + PAD
        fwd = self.grid[e, fx, fy]
        self.steps += 1
        self.dir = np.where(a == LEFT, (self.dir - 1) % 4, self.dir)
        self.dir = np.where(a == RIGHT, (self.dir + 1) % 4, self.dir)
        move = (a == FORWARD) & CAN_OVERLAP[fwd]
        self.pos[move, 0] = fx[move] - PAD
        self.pos[move, 1] = fy[move] - PAD
        terms = (a == FORWARD) & (fwd == GOAL)
        rewards = np.where(terms, 1.0 - 0.9 * self.steps / MAX_STEPS, 0.0)
        new = fwd.copy()
        pick = (a == PICKUP) & (fwd == KEY) & ~self.carrying
        new[pick] = EMPTY
        drop = (a == DROP) & (fwd == EMPTY) & self.carrying
        new[drop] = KEY
        self.carrying = (self.carrying | pick) & ~drop
        tog = a == TOGGLE
        new[tog & (fwd == DOOR_LOCKED) & self.carrying] = DOOR_OPEN
        new[tog & (fwd == DOOR_CLOSED)] = DOOR_OPEN
        new[tog & (fwd == DOOR_OPEN)] = DOOR_CLOSED
        self.grid[e, fx, fy] = new
        truncs = self.steps >= MAX_STEPS
        reset = self.autoreset
        for i in np.flatnonzero(reset):
            self._gen_grid(i)
        rewards[reset] = 0.0
        terms[reset] = False
        truncs[reset] = False
        self.autoreset = terms | truncs
        return self.observe(), rewards, terms, truncs, {}


def make(n_envs: int) -> VecDoorKey:
    return VecDoorKey(n_envs)


def random_actions(rng, n: int) -> np.ndarray:
    """[n] actions drawn uniformly from the action space."""
    return rng.integers(0, N_ACTIONS, n)
