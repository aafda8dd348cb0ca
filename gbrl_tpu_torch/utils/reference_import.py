"""Importer for the reference GBRL binary checkpoint format (.gbrl_model;
counterpart of ``gbrl_tpu/utils/reference_import.py``).

Lets users of NVlabs/gbrl load their trained models directly into this
framework.  Parses the exact byte layout written by GBRL::saveToFile
(gbrl.cpp:1130-1173): serializationHeader (utils.cpp:59-87) +
raw ensembleMetaData struct (types.h:218-242) + flag bytes + learner name +
save_ensemble_data's NULL_CHECK-tagged SoA arrays (types.cpp:681-768) +
serialized optimizers (optimizer.cpp:120-147, scheduler.cpp:64-119), and
converts the leaf-path (GREEDY) / per-tree level (OBLIVIOUS) representation
into this framework's heap-layout ensemble, built on the learner's device.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

MAX_CHAR_SIZE = 128


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        assert len(b) == n, "unexpected end of file"
        self.off += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def array(self, dtype, count: int) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize
        return np.frombuffer(self.take(itemsize * count), dtype=dtype).copy()

    def tagged_array(self, dtype, count: int) -> Optional[np.ndarray]:
        tag = self.u8()                       # NULL_CHECK (types.h:154-157)
        if tag == 1:                          # VALID
            return self.array(dtype, count)
        return None


def parse_reference_file(path: str) -> Dict:
    with open(path, "rb") as f:
        r = _Reader(f.read())

    # serializationHeader: 3x uint16 + pad + uint64 + uint32 + pad = 24 bytes
    major, minor, patch = struct.unpack("<HHH", r.take(6))
    r.take(2)          # alignment padding
    r.u64()            # reserved1
    r.take(4)          # reserved2
    r.take(4)          # struct tail padding (align 8)

    # ensembleMetaData (types.h:218-242): 13 ints, float, 2 ints, bool,
    # 3 uint8 enums, 3 ints -> 80 bytes
    ints = struct.unpack("<13i", r.take(52))
    (n_leaves, n_trees, _max_trees, _max_leaves, _mtb, _mlb, input_dim,
     output_dim, policy_dim, max_depth, min_data_in_leaf, n_bins,
     par_th) = ints
    cv_beta = r.f32()
    verbose = r.i32()
    batch_size = r.i32()
    use_cv_struct = r.u8()
    split_score_func = r.u8()      # 0=L2, 1=Cosine (types.h:145-149)
    generator_type = r.u8()        # 0=Uniform, 1=Quantile
    grow_policy = r.u8()           # 0=GREEDY, 1=OBLIVIOUS
    n_num_features = r.i32()
    n_cat_features = r.i32()
    iteration = r.i32()

    parallel_predict = r.u8()
    use_cv = r.u8()
    name_len = r.u64()
    learner_name = r.take(name_len).decode("utf-8", errors="replace")

    oblivious = grow_policy == 1
    sizes = n_trees if oblivious else n_leaves

    bias = r.tagged_array("<f4", output_dim)
    feature_weights = r.tagged_array("<f4", input_dim)
    tree_indices = r.tagged_array("<i4", n_trees)
    depths = r.tagged_array("<i4", sizes)
    values = r.tagged_array("<f4", n_leaves * output_dim)
    feature_indices = r.tagged_array("<i4", max_depth * sizes)
    feature_values = r.tagged_array("<f4", max_depth * sizes)
    edge_weights = r.tagged_array("<f4", max_depth * n_leaves)
    rev_num_map = r.tagged_array("<i4", input_dim)
    rev_cat_map = r.tagged_array("<i4", input_dim)
    feature_mapping = r.tagged_array("<i4", input_dim)
    mapping_numerics = r.tagged_array("u1", input_dim)
    is_numerics = r.tagged_array("u1", max_depth * sizes)
    inequality_directions = r.tagged_array("u1", max_depth * n_leaves)
    categorical_values = r.tagged_array("S1", max_depth * sizes * MAX_CHAR_SIZE)

    num_opts = r.i32()
    opts = []
    for _ in range(num_opts):
        algo = r.u8()              # 0=SGD, 1=Adam (types.h:115-118)
        start_idx = r.i32()
        stop_idx = r.i32()
        o = dict(algo="Adam" if algo == 1 else "SGD",
                 start_idx=start_idx, stop_idx=stop_idx)
        if algo == 1:
            o["beta_1"] = r.f32()
            o["beta_2"] = r.f32()
            o["eps"] = r.f32()
        sched = r.u8()             # 0=Const, 1=Linear
        o["init_lr"] = r.f32()
        if sched == 1:
            o["scheduler"] = "Linear"
            o["stop_lr"] = r.f32()
            o["T"] = r.i32()
        else:
            o["scheduler"] = "Const"
        opts.append(o)

    return dict(
        version=(major, minor, patch), learner_name=learner_name,
        n_leaves=n_leaves, n_trees=n_trees, input_dim=input_dim,
        output_dim=output_dim, policy_dim=policy_dim, max_depth=max_depth,
        min_data_in_leaf=min_data_in_leaf, n_bins=n_bins, par_th=par_th,
        cv_beta=cv_beta, verbose=verbose, batch_size=batch_size,
        use_cv=bool(use_cv), grow_policy="oblivious" if oblivious else "greedy",
        split_score_func="cosine" if split_score_func == 1 else "l2",
        generator_type="quantile" if generator_type == 1 else "uniform",
        n_num_features=n_num_features, n_cat_features=n_cat_features,
        iteration=iteration, bias=bias, feature_weights=feature_weights,
        tree_indices=tree_indices, depths=depths,
        values=None if values is None else values.reshape(n_leaves, output_dim),
        feature_indices=feature_indices, feature_values=feature_values,
        edge_weights=edge_weights, mapping_numerics=mapping_numerics,
        is_numerics=is_numerics,
        inequality_directions=inequality_directions,
        categorical_values=categorical_values, optimizers=opts,
    )


def _cat_string(catvals: np.ndarray, idx: int) -> bytes:
    s = catvals[idx * MAX_CHAR_SIZE:(idx + 1) * MAX_CHAR_SIZE].tobytes()
    return s.rstrip(b"\x00")


def load_reference_model(path: str, device: str = "cuda"):
    """Parse a reference .gbrl_model file into a ready GBTLearner on
    ``device`` (asking for CUDA without a card raises)."""
    from ..ensemble import ensemble_from_numpy
    from ..learners.gbt_learner import GBTLearner

    m = parse_reference_file(path)
    n_trees = m["n_trees"]
    D = m["max_depth"]
    L = 1 << D
    out = m["output_dim"]

    learner = GBTLearner(
        input_dim=m["input_dim"], output_dim=out,
        tree_struct=dict(max_depth=D, n_bins=m["n_bins"],
                         min_data_in_leaf=m["min_data_in_leaf"],
                         par_th=m["par_th"], batch_size=m["batch_size"],
                         grow_policy=m["grow_policy"]),
        optimizers=m["optimizers"],
        params=dict(split_score_func=m["split_score_func"],
                    generator_type=m["generator_type"],
                    control_variates=m["use_cv"], cv_beta=m["cv_beta"]),
        verbose=m["verbose"], device=device, policy_dim=m["policy_dim"],
        name=m["learner_name"])
    learner.reset()
    if m["mapping_numerics"] is not None:
        learner.set_feature_mapping(m["mapping_numerics"].astype(bool))
    else:
        learner.set_feature_mapping(np.ones(m["input_dim"], dtype=bool))
    if m["feature_weights"] is not None:
        learner.feature_weights = m["feature_weights"].copy()

    vocab = learner.vocab if learner.vocab is not None else None

    def code_of(f_internal: int, raw: bytes) -> int:
        assert vocab is not None
        mp = vocab.maps[f_internal]
        if raw not in mp:
            mp[raw] = len(mp)
        return mp[raw]

    cap = 8
    while cap < max(n_trees, 1):
        cap *= 2
    feat = np.full((cap, L - 1), -1, dtype=np.int32)
    thr = np.zeros((cap, L - 1), dtype=np.float32)
    code = np.full((cap, L - 1), -1, dtype=np.int32)
    is_split = np.zeros((cap, L - 1), dtype=bool)
    is_num = np.ones((cap, L - 1), dtype=bool)
    leaf_values = np.zeros((cap, L, out), dtype=np.float32)
    depths_out = np.zeros((cap,), dtype=np.int32)
    # per-node sample weights reconstructed from the checkpoint's per-leaf
    # edge weights (node.cpp:131,141: edge_weight = child_count/parent_count);
    # absolute counts are not stored, so these hold PATH PROBABILITIES
    # (root = 1).  SHAP only consumes child/parent ratios, which are
    # identical (ops/shap_device.py).
    counts = np.zeros((cap, 2 * L - 1), dtype=np.float32)

    ti = m["tree_indices"]
    vals = m["values"]
    fi = m["feature_indices"]
    fv = m["feature_values"]
    inum = m["is_numerics"]
    ineq = m["inequality_directions"]
    catv = m["categorical_values"]
    dep = m["depths"]

    def leftmost_leaf(p: int, depth: int) -> int:
        q = p
        for _ in range(depth, D):
            q = 2 * q + 1
        return q - (L - 1)

    for t in range(n_trees):
        start = ti[t]
        stop = ti[t + 1] if t + 1 < n_trees else m["n_leaves"]
        if m["grow_policy"] == "oblivious":
            d = dep[t]
            cbase = t * D
            for k in range(d):
                numeric = bool(inum[cbase + k])
                f = int(fi[cbase + k])
                for rel in range(1 << k):
                    p = (1 << k) - 1 + rel
                    is_split[t, p] = True
                    is_num[t, p] = numeric
                    feat[t, p] = f
                    if numeric:
                        thr[t, p] = fv[cbase + k]
                    else:
                        code[t, p] = code_of(f, _cat_string(catv, cbase + k))
            for rel in range(1 << d):
                # reference leaf bits: first condition is the MSB
                # (predictor.cpp:254-256) == heap walk order
                leaf_values[t, leftmost_leaf((1 << d) - 1 + rel, d)] = \
                    vals[start + rel]
            ew = m["edge_weights"]
            counts[t, 0] = 1.0
            for rel in range(1 << d):
                p, w = 0, 1.0
                for k in range(d):
                    bit = (rel >> (d - 1 - k)) & 1
                    p = 2 * p + 1 + bit
                    w *= float(ew[(start + rel) * D + k])
                    counts[t, p] = w
                for _ in range(d, D):          # pass-through spine
                    p = 2 * p + 1
                    counts[t, p] = w
            depths_out[t] = d
        else:
            for leaf in range(start, stop):
                d = dep[leaf]
                cbase = leaf * D
                p = 0
                for k in range(d):
                    numeric = bool(inum[cbase + k])
                    f = int(fi[cbase + k])
                    is_split[t, p] = True
                    is_num[t, p] = numeric
                    feat[t, p] = f
                    if numeric:
                        thr[t, p] = fv[cbase + k]
                    else:
                        code[t, p] = code_of(f, _cat_string(catv, cbase + k))
                    go_right = bool(ineq[cbase + k])
                    p = 2 * p + 1 + int(go_right)
                leaf_values[t, leftmost_leaf(p, d)] = vals[leaf]
                counts[t, 0] = 1.0
                q, w = 0, 1.0
                ew = m["edge_weights"]
                for k in range(d):
                    q = 2 * q + 1 + int(ineq[cbase + k])
                    w *= float(ew[leaf * D + k])
                    counts[t, q] = w
                for _ in range(d, D):          # pass-through spine
                    q = 2 * q + 1
                    counts[t, q] = w
                depths_out[t] = max(depths_out[t], d)

    learner.ens = ensemble_from_numpy(dict(
        feat=feat, thr=thr, cat_code=code, is_split=is_split,
        is_numeric=is_num, leaf_values=leaf_values, counts=counts,
        depths=depths_out,
        bias=(m["bias"] if m["bias"] is not None
              else np.zeros(out, np.float32)),
        n_trees=np.asarray(n_trees, np.int32)), learner.torch_device)
    learner.total_iterations = m["iteration"]
    # wholesale ensemble replacement: disarm any RL host tree counter and
    # force mirrors to re-fetch the bias on their next sync
    learner._rl_host_n_trees = None
    learner._bias_version = getattr(learner, "_bias_version", 0) + 1
    return learner
