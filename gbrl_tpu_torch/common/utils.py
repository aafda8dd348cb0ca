"""Host-side data plumbing: dtype rules, numeric/categorical splitting,
optimizer-dict validation, gradient clipping, device resolution.

Copy of ``gbrl_tpu/common/utils.py`` (reference gbrl/common/utils.py:
process_array:63-129, get_index_mapping:132-164, setup_optimizer:228-267,
clip_grad_norm:270-295) with two changes: ``ensure_leaf_output`` returns a
tensor on the learner's device, and ``resolve_device`` turns a device string
into a ``torch.device``, refusing ``cuda`` when no card is present.
Categorical values are dictionary-encoded to int32 codes per feature (the
learner owns the vocabulary) instead of S128 byte strings.
"""
from __future__ import annotations

import itertools
import operator
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch as th

from ..config import APPROVED_OPTIMIZERS, VALID_OPTIMIZER_ARGS
from ..utils import profiling

numerical_dtype = np.dtype("float32")
categorical_dtype = np.dtype("S128")   # accepted on input, re-encoded to codes

NumericalData = Union[np.ndarray, th.Tensor]


def resolve_device(device: Union[str, th.device]) -> th.device:
    """``"cuda"`` / ``"cuda:1"`` / ``"cpu"`` -> torch.device.  Raises when a
    CUDA device is asked for and ``torch.cuda.is_available()`` is false:
    the port never carries on quietly on the CPU."""
    dev = th.device(device)
    if dev.type == "cuda" and not th.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was requested but no CUDA "
                           "device is available; pass device='cpu' to run on "
                           "the CPU")
    return dev


def is_torch(arr) -> bool:
    return isinstance(arr, th.Tensor)


def to_numpy(arr) -> np.ndarray:
    if is_torch(arr):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr, dtype=numerical_dtype)


def ensure_2d(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 1:
        return arr[:, None]
    return arr


def _numeric_mask(first_row) -> np.ndarray:
    return np.array([isinstance(x, (int, float, np.integer, np.floating))
                     for x in first_row], dtype=bool)


def process_array(arr: np.ndarray) -> Tuple[Optional[np.ndarray],
                                            Optional[np.ndarray]]:
    """Split an input array into (numerical float32, categorical str) parts.

    Reference: common/utils.py:63-129.  Categorical output is a unicode
    string array (vocabulary encoding happens in the learner).
    """
    if np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.integer) \
            or arr.dtype == np.bool_:
        return np.ascontiguousarray(arr, dtype=numerical_dtype), None
    if arr.dtype.kind in ("U", "S"):
        return None, arr.astype(str)
    if arr.dtype == object:
        first_row = arr if arr.ndim == 1 else arr[0]
        num_mask = _numeric_mask(first_row)
        cat_mask = ~num_mask
        num = None
        cat = None
        if num_mask.any():
            sel = arr[num_mask] if arr.ndim == 1 else arr[:, num_mask]
            num = np.ascontiguousarray(sel.astype(numerical_dtype))
        if cat_mask.any():
            sel = arr[cat_mask] if arr.ndim == 1 else arr[:, cat_mask]
            cat = sel.astype(str)
        return num, cat
    raise ValueError(f"Unsupported array data type: {arr.dtype}")


def get_index_mapping(arr) -> Tuple[np.ndarray, np.ndarray]:
    """original column index -> index within its (num|cat) block, plus a
    boolean numeric mask (reference: common/utils.py:132-164)."""
    if is_torch(arr):
        return np.arange(arr.shape[-1]), np.ones(arr.shape[-1], dtype=bool)
    arr = np.asarray(arr)
    if np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.integer):
        return np.arange(arr.shape[-1]), np.ones(arr.shape[-1], dtype=bool)
    if arr.dtype.kind in ("U", "S"):
        return np.arange(arr.shape[-1]), np.zeros(arr.shape[-1], dtype=bool)
    first_row = arr if arr.ndim == 1 else arr[0]
    num_mask = _numeric_mask(first_row)
    idx_map = np.empty(arr.shape[-1], dtype=int)
    idx_map[num_mask] = np.arange(num_mask.sum())
    idx_map[~num_mask] = np.arange((~num_mask).sum())
    return idx_map, num_mask


def preprocess_features(arr) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Input of any supported kind -> (num float32 2D | None, cat str 2D | None)."""
    if isinstance(arr, tuple):
        num, cat = arr
        num = None if num is None else ensure_2d(to_numpy(num))
        cat = None if cat is None else ensure_2d(np.asarray(cat).astype(str))
        return num, cat
    if is_torch(arr):
        return ensure_2d(to_numpy(arr)), None
    arr = np.asarray(arr)
    if arr.ndim == 0:
        arr = arr[None]
    num, cat = process_array(arr)
    num = None if num is None else ensure_2d(num)
    cat = None if cat is None else ensure_2d(cat)
    return num, cat


def get_input_dim(arr) -> int:
    if isinstance(arr, tuple):
        return sum(get_input_dim(a) for a in arr if a is not None)
    a = np.asarray(arr) if not is_torch(arr) else arr
    return 1 if a.ndim == 1 else a.shape[-1]


def validate_array(arr) -> None:
    """NaN/Inf gate (reference: common/utils.py validate_array)."""
    a = to_numpy(arr) if not isinstance(arr, np.ndarray) else arr
    if np.isnan(a).any():
        raise ValueError("Array contains NaN values")
    if np.isinf(a).any():
        raise ValueError("Array contains Inf values")


def clip_grad_norm(grads, grad_clip: Optional[float]):
    """Per-sample L2 clipping (reference: common/utils.py:270-295)."""
    if grad_clip is None or grad_clip == 0.0:
        return grads
    if is_torch(grads):
        if grads.dim() == 1:
            return th.clamp(grads, min=-grad_clip, max=grad_clip)
        norms = th.norm(grads, p=2, dim=1, keepdim=True)
        mask = (norms > grad_clip).squeeze(-1)
        grads = grads.clone()
        grads[mask] = grad_clip * grads[mask] / norms[mask]
        return grads
    grads = np.asarray(grads)
    if grads.ndim == 1:
        return np.clip(grads, a_min=-grad_clip, a_max=grad_clip)
    norms = np.linalg.norm(grads, axis=1, ord=2, keepdims=True)
    mask = (norms > grad_clip).squeeze(-1)
    grads = grads.copy()
    grads[mask] = grad_clip * grads[mask] / norms[mask]
    return grads


def setup_optimizer(optimizer: Dict, prefix: str = "") -> Dict:
    """Validate/normalize an optimizer dict (reference: common/utils.py:228-267).

    Handles prefix stripping ('policy_lr' -> 'lr'), the 'lin_<lr>' string
    convention selecting the Linear scheduler, and the VALID_OPTIMIZER_ARGS
    whitelist.
    """
    assert isinstance(optimizer, dict), "optimizer must be a dictionary"
    assert "start_idx" in optimizer, "optimizer must have a start idx"
    assert "stop_idx" in optimizer, "optimizer must have a stop idx"
    if prefix:
        optimizer = {k.replace(prefix, ""): v for k, v in optimizer.items()}
    lr = optimizer.get("lr", 1.0) if "init_lr" not in optimizer else \
        optimizer["init_lr"]
    optimizer["scheduler"] = "Const"
    assert isinstance(lr, (int, float, str)), "lr must be a float or string"
    if isinstance(lr, str) and "lin_" in lr:
        assert "T" in optimizer, \
            "Linear scheduler requires T, the total number of boosting trees"
        lr = lr.replace("lin_", "")
        optimizer["scheduler"] = "Linear"
    optimizer["init_lr"] = float(lr)
    optimizer["algo"] = optimizer.get("algo", "SGD")
    assert optimizer["algo"] in APPROVED_OPTIMIZERS, \
        f"optimization algo has to be in {APPROVED_OPTIMIZERS}"
    return {k: v for k, v in optimizer.items()
            if k in VALID_OPTIMIZER_ARGS and v is not None}


def concatenate_arrays(a, b, axis: int = 1):
    if a is None:
        return b
    if b is None:
        return a
    if is_torch(a) and is_torch(b):
        return th.cat([a, b], dim=axis)
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=axis)


def pad_array(arr: np.ndarray, target_rows: int, value: float = 0.0) -> np.ndarray:
    """Pad rows up to target_rows (reference: common/utils.py pad_array)."""
    arr = np.asarray(arr)
    if arr.shape[0] >= target_rows:
        return arr
    pad = np.full((target_rows - arr.shape[0],) + arr.shape[1:], value,
                  dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def get_tensor_info(tensor) -> Tuple[int, Tuple[int, ...], str, str]:
    """(data_ptr, shape, dtype, device) tuple for a torch tensor
    (reference: common/utils.py:43-60)."""
    assert is_torch(tensor), "get_tensor_info expects a torch tensor"
    return (tensor.data_ptr(), tuple(tensor.shape), str(tensor.dtype),
            str(tensor.device))


def get_poly_vectors(max_depth: int, dtype=np.float32):
    """Chebyshev-of-second-kind points + normalization/offset matrices used
    by the reference's Linear TreeSHAP (common/utils.py:317-371); provided
    for API parity with callers that pass them through.

    Returns (base_poly [D+1], norm_values [D+1, D+1], offset [D+1])."""
    d = max_depth + 1
    base_poly = np.cos(np.pi * (np.arange(1, d + 1) - 0.5) / d).astype(dtype)
    vander = np.vander(base_poly, d, increasing=True).astype(dtype)
    norm_values = np.linalg.inv(vander).astype(dtype)
    offset = (base_poly + 1.0).astype(dtype)
    return base_poly, norm_values, offset


def ensure_leaf_output(array: th.Tensor, tensor: bool, requires_grad: bool):
    """Prediction tensor -> a fresh contiguous f32 leaf tensor on the same
    device (``requires_grad`` as asked), or a numpy array when ``tensor`` is
    False (reference: common/utils.py:561-596 ensure_leaf_tensor_or_array).
    The copy keeps callers from writing into the learner's predict cache."""
    t = array.detach().to(th.float32, copy=True).contiguous()
    if not tensor:
        return t.cpu().numpy()
    if requires_grad:
        t.requires_grad_(True)
    return t


class _VocabTable(NamedTuple):
    """``CategoryVocab``'s maps as arrays, for ``U{width}`` cells: every
    entry such a cell can equal, sorted by a uint64 key that is the
    wrapping sum of its words times ``mult`` and its feature's term (odd
    multiples, so equal keys and equal words mean equal features; keys
    that collide only cost misses)."""
    dicts: tuple            # the maps it was read from, and their sizes
    sizes: tuple
    width: int
    keys: np.ndarray        # [K] uint64, sorted
    words: np.ndarray       # [K, width // 2] uint64
    codes: np.ndarray       # [K] int32
    mult: np.ndarray        # [width // 2] uint64
    feat_terms: np.ndarray  # [Fc] uint64


class CategoryVocab:
    """Per-feature string -> int32 code dictionaries (replaces the
    reference's S128 string storage, types.h MAX_CHAR_SIZE=128).

    Values are canonicalized to their first 128 UTF-8 bytes (the reference
    truncates identically).

    ``encode`` first looks the whole batch up in a table of the (feature,
    value) pairs the maps hold (``_VocabTable``); only the cells it misses
    go through the per-feature dicts.  The table holds each value as the
    UCS4 words of a unicode array, so it serves ``U`` batches of at most 32
    characters: their UTF-8 form is at most 128 bytes, never truncated, so
    equal words are equal canonical keys.  The maps grow by insertion: the
    table takes in the entries added since it was read, and is read anew
    when ``maps`` or one of its dicts is replaced, a map shrinks, or for
    another string width.
    """
    STRIDE = 128
    MAX_TABLE_CHARS = STRIDE // 4       # UTF-8 spends at most 4 bytes a char

    def __init__(self, n_features: int):
        # bytes (<=128) -> code, insertion-ordered
        self.maps: List[Dict[bytes, int]] = [dict() for _ in range(n_features)]
        self._table: Optional[_VocabTable] = None

    def _canon_matrix(self, cat: np.ndarray) -> np.ndarray:
        return np.char.encode(cat.astype(str), "utf-8").astype(
            f"S{self.STRIDE}")

    @staticmethod
    def _words(cat: np.ndarray, width: int) -> np.ndarray:
        """[N, F] or [K] unicode -> [N * F, width // 2] uint64: each cell's
        UCS4 words, two to a uint64 (``width`` even, padded with NULs)."""
        return np.ascontiguousarray(cat, dtype=f"U{width}").view(
            np.uint64).reshape(-1, width // 2)

    def _lookup_table(self, width: int) -> _VocabTable:
        t = self._table
        if t is not None and not (t.width == width
                                  and len(self.maps) == len(t.dicts)
                                  and all(map(operator.is_, self.maps,
                                              t.dicts))):
            t = None
        sizes = tuple(map(len, self.maps))
        if t is not None:
            if t.sizes == sizes:
                return t
            if not all(map(operator.ge, sizes, t.sizes)):
                t = None
        vals, feats, codes = [], [], []
        for f, m in enumerate(self.maps):
            for key, code in itertools.islice(m.items(),
                                              t.sizes[f] if t else 0, None):
                try:
                    s = key.decode("utf-8")
                except UnicodeDecodeError:
                    continue
                # a U array drops trailing NULs, so such a key equals no cell
                if len(s) <= width and not s.endswith("\x00"):
                    vals.append(s)
                    feats.append(f)
                    codes.append(code)
        if t is None:
            mult = (np.arange(1, width // 2 + 2, dtype=np.uint64)
                    * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
            feat_terms = np.arange(len(sizes), dtype=np.uint64) * mult[-1]
            t = _VocabTable((), (), width,
                            np.zeros(0, np.uint64),
                            np.zeros((0, width // 2), np.uint64),
                            np.zeros(0, np.int32), mult[:-1], feat_terms)
        words = self._words(np.array(vals, dtype=f"U{width}"), width)
        keys = np.concatenate([t.keys, words @ t.mult + t.feat_terms[
            np.array(feats, dtype=np.int64)]])
        order = np.argsort(keys, kind="stable")
        self._table = t._replace(
            dicts=tuple(self.maps), sizes=sizes, keys=keys[order],
            words=np.concatenate([t.words, words])[order],
            codes=np.concatenate([t.codes, np.array(codes, np.int32)])[order])
        return self._table

    def _lookup(self, cat: np.ndarray):
        """(codes [N, F] i32, hit [N, F] bool): the codes of the cells the
        table holds where ``hit``, anything elsewhere; no hit where the
        table cannot vouch for the batch's dtype."""
        N, F = cat.shape
        chars = cat.dtype.itemsize // 4
        t = None
        if cat.dtype.kind == "U" and 0 < chars <= self.MAX_TABLE_CHARS:
            t = self._lookup_table(chars + chars % 2)
        if t is None or len(t.keys) == 0 or cat.size == 0:
            return np.empty((N, F), np.int32), np.zeros((N, F), bool)
        words = self._words(cat, t.width)
        keys = ((words @ t.mult).reshape(N, F)
                + t.feat_terms[:F]).reshape(-1)
        # the last entry is where a key above all the others must be
        idx = np.searchsorted(t.keys[:-1], keys)
        hit = t.keys.take(idx) == keys
        # word for word: a row with any differing word is no hit
        hit[np.flatnonzero(t.words.take(idx, axis=0) != words)
            // words.shape[1]] = False
        return t.codes.take(idx).reshape(N, F), hit.reshape(N, F)

    def encode(self, cat: np.ndarray, grow: bool) -> np.ndarray:
        """[N, Fc] str -> [N, Fc] int32; unseen values get new codes when
        grow=True (fitting) or -1 when frozen (prediction).

        The table lookup resolves the cells whose value the maps hold; the
        rest (all cells of an input the table cannot serve) take the
        per-feature path, where np.unique compresses the column's missed
        cells to their uniques, so the dict only sees O(uniques) keys per
        call (new codes are assigned in sorted order of the batch's unseen
        values — deterministic).  The cells each way resolved are counted
        as ``vocab.hit`` / ``vocab.miss``, the codes added as
        ``vocab.new_codes`` (utils/profiling.py)."""
        out, hit = self._lookup(cat)
        n_hit = int(np.count_nonzero(hit))
        if n_hit:
            profiling.count("vocab.hit", n_hit)
        n_miss = hit.size - n_hit
        if n_miss == 0:
            return out
        profiling.count("vocab.miss", n_miss)
        miss = ~hit
        cols = np.flatnonzero(miss.any(axis=0))
        cb = self._canon_matrix(cat[:, cols])            # [N, C] S128
        added = 0
        for j, f in enumerate(cols):
            m = self.maps[f]
            rows = np.flatnonzero(miss[:, f])
            uniq, inv = np.unique(cb[rows, j], return_inverse=True)
            codes = np.empty(len(uniq), dtype=np.int32)
            for u_idx, u in enumerate(uniq):
                key = bytes(u)
                if key in m:
                    codes[u_idx] = m[key]
                elif grow:
                    m[key] = len(m)
                    codes[u_idx] = m[key]
                    added += 1
                else:
                    codes[u_idx] = -1
            out[rows, f] = codes[inv]
        if added:
            profiling.count("vocab.new_codes", added)
        return out

    def decode_table(self) -> List[List[bytes]]:
        return [[k for k, _ in sorted(m.items(), key=lambda kv: kv[1])]
                for m in self.maps]

    def to_state(self) -> List[Dict[str, int]]:
        return [{k.hex(): v for k, v in m.items()} for m in self.maps]

    @staticmethod
    def from_state(state: List[Dict[str, int]]) -> "CategoryVocab":
        v = CategoryVocab(len(state))
        v.maps = [{bytes.fromhex(k): c for k, c in m.items()} for m in state]
        return v
