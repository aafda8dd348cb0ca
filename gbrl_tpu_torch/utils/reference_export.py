"""Exporter to the reference GBRL binary checkpoint format (.gbrl_model;
counterpart of ``gbrl_tpu/utils/reference_export.py``, byte for byte).

The inverse of reference_import: models trained in this framework can be
handed back to the reference C++ library (or any GBRL_SB3 pipeline).  Writes
the exact layout of GBRL::saveToFile (gbrl.cpp:1130-1173) at format version
1.1.6: header + raw ensembleMetaData + flags + learner name +
NULL_CHECK-tagged SoA arrays (types.cpp:681-768) + optimizer records.

Heap trees are converted back to the reference's representations:
- GREEDY: leaves enumerated in the reference fitter's DFS order
  (left child first, fitter.cpp:364-365) with per-leaf path-condition lists
  and inequality directions;
- OBLIVIOUS: per-tree level conditions + bit-indexed leaf values.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

MAX_CHAR_SIZE = 128
_SCORE = {"l2": 0, "cosine": 1}
_GEN = {"uniform": 0, "quantile": 1}
_POLICY = {"greedy": 0, "oblivious": 1}


def _pack_header(version=(1, 1, 6)) -> bytes:
    return struct.pack("<HHH", *version) + b"\x00" * 2 + \
        struct.pack("<Q", 0) + struct.pack("<I", 0) + b"\x00" * 4


def _tagged(out: List[bytes], arr: Optional[np.ndarray]):
    if arr is None:
        out.append(b"\x00")                      # NULL_OPT
    else:
        out.append(b"\x01")                      # VALID
        out.append(np.ascontiguousarray(arr).tobytes())


def export_reference_model(learner, path: str) -> None:
    """Write a GBTLearner's ensemble as a reference-compatible .gbrl_model."""
    cfg = learner.cfg
    ens = learner.ens
    D = cfg.max_depth
    L = 1 << D
    out_dim = cfg.output_dim
    oblivious = cfg.oblivious
    T = int(ens.n_trees)

    feat = ens.feat[:T].cpu().numpy()
    thr = ens.thr[:T].cpu().numpy()
    code = ens.cat_code[:T].cpu().numpy()
    is_split = ens.is_split[:T].cpu().numpy()
    is_num = ens.is_numeric[:T].cpu().numpy()
    lv = ens.leaf_values[:T].cpu().numpy()
    counts = ens.counts[:T].cpu().numpy()

    decode = (learner.vocab.decode_table() if learner.vocab is not None
              else [])

    def cat_bytes(f_internal: int, c: int) -> bytes:
        s = decode[f_internal][c] if 0 <= c < len(decode[f_internal]) else b""
        return s.ljust(MAX_CHAR_SIZE, b"\x00")[:MAX_CHAR_SIZE]

    # --- walk every tree back into leaf-path form -------------------------
    tree_indices: List[int] = []
    depths_arr: List[int] = []            # per tree (obl) or per leaf (greedy)
    values: List[np.ndarray] = []
    fi: List[List[int]] = []              # conditions per `sizes` row
    fvv: List[List[float]] = []
    inm: List[List[bool]] = []
    catv: List[List[bytes]] = []
    ineq: List[List[bool]] = []           # per leaf
    eweights: List[List[float]] = []      # per leaf

    def leftmost_leaf(p: int, depth: int) -> int:
        q = p
        for _ in range(depth, D):
            q = 2 * q + 1
        return q - (L - 1)

    n_leaves = 0
    for t in range(T):
        tree_indices.append(n_leaves)
        if oblivious:
            # depth = number of split levels (all nodes of a level share one)
            d = 0
            while d < D and is_split[t, (1 << d) - 1]:
                d += 1
            depths_arr.append(d)
            conds_f, conds_v, conds_n, conds_c = [], [], [], []
            for k in range(d):
                p = (1 << k) - 1
                conds_f.append(int(feat[t, p]))
                conds_v.append(float(thr[t, p]))
                conds_n.append(bool(is_num[t, p]))
                conds_c.append(b"" if is_num[t, p] else
                               cat_bytes(int(feat[t, p]), int(code[t, p])))
            fi.append(conds_f)
            fvv.append(conds_v)
            inm.append(conds_n)
            catv.append(conds_c)
            for rel in range(1 << d):
                values.append(lv[t, leftmost_leaf((1 << d) - 1 + rel, d)])
                # bit k of rel (MSB-first) is that level's direction
                ineq.append([bool((rel >> (d - 1 - k)) & 1) for k in range(d)])
                ew = []
                p = 0
                for k in range(d):
                    go = (rel >> (d - 1 - k)) & 1
                    child = 2 * p + 1 + go
                    parent_n = counts[t, p]
                    ew.append(float(counts[t, child] / parent_n)
                              if parent_n > 0 else 0.0)
                    p = child
                eweights.append(ew)
                n_leaves += 1
        else:
            # DFS, left child first == reference emission order
            # (fitter.cpp:292-371 pops left first from the stack)
            stack = [(0, 0, [], [], [], [], [], [])]
            while stack:
                (p, depth, cf, cv, cn, cc, ci, ce) = stack.pop()
                if depth == D or not is_split[t, p]:
                    depths_arr.append(depth)
                    fi.append(cf)
                    fvv.append(cv)
                    inm.append(cn)
                    catv.append(cc)
                    ineq.append(ci)
                    eweights.append(ce)
                    values.append(lv[t, leftmost_leaf(p, depth)])
                    n_leaves += 1
                    continue
                f = int(feat[t, p])
                numeric = bool(is_num[t, p])
                v = float(thr[t, p]) if numeric else float("inf")
                cb = b"" if numeric else cat_bytes(f, int(code[t, p]))
                parent_n = counts[t, p]
                kids = []
                for go in (0, 1):
                    child = 2 * p + 1 + go
                    ew = (float(counts[t, child] / parent_n)
                          if parent_n > 0 else 0.0)
                    kids.append((child, depth + 1, cf + [f], cv + [v],
                                 cn + [numeric], cc + [cb], ci + [bool(go)],
                                 ce + [ew]))
                stack.append(kids[1])      # right pushed first,
                stack.append(kids[0])      # left popped first

    sizes = T if oblivious else n_leaves

    def cond_matrix(rows, fill, dtype):
        m = np.full((sizes, D), fill, dtype=dtype)
        for i, row in enumerate(rows):
            for k, v in enumerate(row):
                m[i, k] = v
        return m

    fi_m = cond_matrix(fi, -1, np.int32)
    fv_m = cond_matrix(fvv, np.float32(np.inf), np.float32)
    in_m = cond_matrix(inm, True, np.uint8)
    ineq_m = np.zeros((n_leaves, D), dtype=np.uint8)
    ew_m = np.ones((n_leaves, D), dtype=np.float32)
    for i, row in enumerate(ineq):
        for k, v in enumerate(row):
            ineq_m[i, k] = v
    for i, row in enumerate(eweights):
        for k, v in enumerate(row):
            ew_m[i, k] = v
    cat_m = np.zeros((sizes, D, MAX_CHAR_SIZE), dtype="S1")
    for i, row in enumerate(catv):
        for k, v in enumerate(row):
            if v:
                cat_m[i, k] = np.frombuffer(v, dtype="S1")

    n_num = cfg.n_num_features
    n_cat = cfg.n_cat_features
    input_dim = learner.input_dim
    num_mask = learner.num_mask.astype(np.uint8)
    idx_map = np.zeros(input_dim, dtype=np.int32)
    idx_map[learner.num_mask] = np.arange(n_num)
    idx_map[~learner.num_mask] = np.arange(input_dim - n_num)
    rev_num = np.full(input_dim, -1, dtype=np.int32)
    rev_cat = np.full(input_dim, -1, dtype=np.int32)
    rev_num[:n_num] = np.where(learner.num_mask)[0]
    if n_cat:
        rev_cat[:n_cat] = np.where(~learner.num_mask)[0]

    out: List[bytes] = [_pack_header()]
    # ensembleMetaData (80 bytes, types.h:218-242)
    out.append(struct.pack(
        "<13i", n_leaves, T, max(T, 1), max(n_leaves, 1), 1, 1, input_dim,
        out_dim, cfg.policy_dim, D, cfg.min_data_in_leaf, cfg.n_bins,
        cfg.par_th))
    out.append(struct.pack("<f", cfg.cv_beta))
    out.append(struct.pack("<ii", cfg.verbose, cfg.batch_size))
    out.append(struct.pack("<BBBB", int(cfg.use_control_variates),
                           _SCORE[cfg.score], _GEN[cfg.generator],
                           _POLICY[cfg.grow_policy]))
    out.append(struct.pack("<iii", n_num, n_cat, learner.total_iterations))
    out.append(b"\x01")       # parallel_predict
    out.append(bytes([int(cfg.use_control_variates)]))
    name = learner.learner_name.encode()
    out.append(struct.pack("<Q", len(name)))
    out.append(name)

    _tagged(out, ens.bias.cpu().numpy().astype(np.float32))
    _tagged(out, learner.feature_weights.astype(np.float32))
    _tagged(out, np.asarray(tree_indices, dtype=np.int32))
    _tagged(out, np.asarray(depths_arr, dtype=np.int32))
    _tagged(out, np.asarray(values, dtype=np.float32))
    _tagged(out, fi_m)
    _tagged(out, fv_m)
    _tagged(out, ew_m)
    _tagged(out, rev_num)
    _tagged(out, rev_cat)
    _tagged(out, idx_map)
    _tagged(out, num_mask)
    _tagged(out, in_m)
    _tagged(out, ineq_m)
    _tagged(out, cat_m)

    out.append(struct.pack("<i", len(learner.specs)))
    for s in learner.specs:
        out.append(bytes([1 if s.algo == "Adam" else 0]))
        out.append(struct.pack("<ii", s.start_idx, s.stop_idx))
        if s.algo == "Adam":
            out.append(struct.pack("<fff", s.beta_1, s.beta_2, s.eps))
        if s.scheduler == "Linear":
            out.append(b"\x01")
            out.append(struct.pack("<ffi", s.init_lr, s.stop_lr, s.T))
        else:
            out.append(b"\x00")
            out.append(struct.pack("<f", s.init_lr))

    with open(path, "wb") as f:
        f.write(b"".join(out))
