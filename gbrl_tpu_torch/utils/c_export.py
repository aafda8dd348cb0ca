"""Self-contained C-header inference export (deployment path; counterpart
of ``gbrl_tpu/utils/c_export.py``).

Analog of the reference's export_ensemble_data (types.cpp:409-676): emits a
header with the ensemble baked into static arrays and a ``<name>_predict``
function, for embedded / dependency-free inference.

Formats: ``float``, ``fxp8`` (Q8 fixed point, int16 features / int32
accumulation) and ``fxp16`` (Q16, int32/int64).  SGD-only (learning rates
are folded into the leaf values, so prediction is bias + sum of scaled
leaves).

Export types (types.h:170-174):
  - ``full``    — per-node heap walk; both grow policies, any depth.
  - ``compact`` — oblivious-only, max_depth <= 6 (the reference's own
    restriction, types.cpp:427-429): one condition per *level* instead of
    per node (D conditions vs 2^D - 1), with the leaf index assembled from
    the level comparison bits.  Identical output, smaller tables.

Categorical features (beyond the reference, which exports numeric-only):
when the config has categorical features the predictor takes a second
``const int *cat_features`` argument holding per-feature vocabulary codes
(code == split code routes right, matching node.cpp:89 semantics; unseen
values encode to -1 and route left).  When a ``CategoryVocab`` is supplied,
a ``<name>_cat_code(feature, str)`` helper with the baked-in vocabulary is
emitted so deployments can encode raw strings without this library.

The ensemble's fields are copied to the host once; the learning rates are
folded with the port's own ``scheduler_lr`` in float32 on the CPU.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..config import TreeConfig
from ..ensemble import Ensemble
from ..optimizers import OptimizerSpec, scheduler_lr


def _fmt_array(vals, per_line: int = 16) -> str:
    toks = [str(v) for v in vals]
    lines = [", ".join(toks[i:i + per_line])
             for i in range(0, len(toks), per_line)]
    return ",\n    ".join(lines)


def _c_string(b: bytes) -> str:
    out = []
    for ch in b:
        if ch in (0x22, 0x5c):          # " and backslash
            out.append("\\" + chr(ch))
        elif 0x20 <= ch < 0x7f:
            out.append(chr(ch))
        else:
            out.append(f"\\{ch:03o}")
    return '"' + "".join(out) + '"'


def _extract_levels(cfg: TreeConfig, feat, thr, is_split, is_num, catcode):
    """Per-level condition tables for COMPACT export.

    Oblivious trees share one condition across each level (fitter.cpp's
    oblivious mode); validated here rather than assumed.  Returns
    [T, D]-shaped feat/thr/catcode plus level split/numeric bitmasks.
    """
    T = feat.shape[0]
    D = cfg.max_depth
    lf = np.zeros((T, D), dtype=np.int64)
    lt = np.zeros((T, D), dtype=np.float64)
    lc = np.full((T, D), -1, dtype=np.int64)
    lsplit = np.zeros(T, dtype=np.uint64)
    lnum = np.zeros(T, dtype=np.uint64)
    for d in range(D):
        lo, hi = (1 << d) - 1, (1 << (d + 1)) - 1
        for name, arr in (("is_split", is_split[:, lo:hi]),
                          ("feat", feat[:, lo:hi]),
                          ("thr", thr[:, lo:hi]),
                          ("cat_code", catcode[:, lo:hi]),
                          ("is_numeric", is_num[:, lo:hi])):
            if not (arr == arr[:, :1]).all():
                raise ValueError(
                    f"compact export requires oblivious trees: {name} "
                    f"differs within level {d}")
        lf[:, d] = feat[:, lo]
        lt[:, d] = thr[:, lo]
        lc[:, d] = catcode[:, lo]
        lsplit |= is_split[:, lo].astype(np.uint64) << np.uint64(d)
        lnum |= is_num[:, lo].astype(np.uint64) << np.uint64(d)
    return lf, lt, lc, lsplit, lnum


def export_ensemble_header(cfg: TreeConfig, ens: Ensemble, filename: str,
                           modelname: str = "gbrl_model",
                           specs: Sequence[OptimizerSpec] = (),
                           export_format: str = "float",
                           export_type: str = "full",
                           vocab=None) -> None:
    for s in specs:
        if s.algo != "SGD":
            raise ValueError("C export requires SGD optimizers "
                             "(lr is folded into leaf values)")
    fmt = export_format.lower()
    if fmt not in ("float", "fxp8", "fxp16"):
        raise ValueError("export_format must be float|fxp8|fxp16")
    etype = export_type.lower()
    if etype not in ("full", "compact"):
        raise ValueError("export_type must be full|compact")
    if etype == "compact" and (cfg.grow_policy != "oblivious"
                               or cfg.max_depth > 6):
        # same gate as the reference (types.cpp:427-429)
        raise ValueError("compact export requires oblivious trees with "
                         "max_depth <= 6")

    T = int(ens.n_trees)
    D = cfg.max_depth
    L = cfg.n_leaves
    NODES = L - 1
    O = cfg.output_dim
    FC = cfg.n_cat_features
    has_cat = FC > 0

    feat = ens.feat[:T].cpu().numpy().astype(np.int64)       # [T, NODES]
    thr = ens.thr[:T].cpu().numpy().astype(np.float64)
    is_split = ens.is_split[:T].cpu().numpy().astype(bool)
    is_num = ens.is_numeric[:T].cpu().numpy().astype(bool)
    catcode = ens.cat_code[:T].cpu().numpy().astype(np.int64)
    lv = ens.leaf_values[:T].cpu().numpy().astype(np.float64)  # [T, L, O]
    bias = ens.bias.cpu().numpy().astype(np.float64)

    # fold -lr(t) per optimizer column range into leaf values
    if specs and T > 0:
        coeff = np.zeros((T, O))
        t = torch.arange(T)
        for s in specs:
            lr = scheduler_lr(s, t).numpy().astype(np.float64)
            coeff[:, s.start_idx:s.stop_idx] += -lr[:, None]
        lv = lv * coeff[:, None, :]
    elif T > 0:
        lv = -lv

    if fmt == "float":
        ftype, acct, scale = "float", "float", None
    elif fmt == "fxp8":
        ftype, acct, scale = "short", "int", 8
    else:
        ftype, acct, scale = "int", "long long", 16

    def q(x):
        if scale is None:
            s = f"{x:.9g}"
            if "." not in s and "e" not in s and "inf" not in s and \
                    "nan" not in s:
                s += ".0"
            return s + "f"
        return str(int(round(x * (1 << scale))))

    up = modelname.upper()
    sig_cat = ", const int *cat_features" if has_cat else ""
    h = []
    h.append(f"/* Auto-generated by gbrl_tpu_torch: {T} {cfg.grow_policy} "
             f"trees, depth {D}, output_dim {O}, format {fmt}, type {etype}"
             + (f", {FC} categorical features" if has_cat else "") + ". */")
    h.append(f"#ifndef {up}_H")
    h.append(f"#define {up}_H")
    h.append(f"#define {up}_N_TREES {T}")
    h.append(f"#define {up}_N_FEATURES {cfg.n_num_features}")
    if has_cat:
        h.append(f"#define {up}_N_CAT_FEATURES {FC}")
    h.append(f"#define {up}_N_OUTPUTS {O}")
    h.append(f"#define {up}_DEPTH {D}")
    if scale is not None:
        h.append(f"#define {up}_FRAC_BITS {scale}  "
                 f"/* features must be pre-scaled by 1<<{scale} */")

    def emit_arr(ctype, name, vals, empty, per_line=8):
        h.append(f"static const {ctype} {modelname}_{name}"
                 f"[{max(len(vals), 1)}] = {{")
        h.append("    " + _fmt_array(vals if len(vals) else [empty],
                                     per_line) + "};")

    if etype == "compact":
        lf, lt, lc, lsplit, lnum = _extract_levels(
            cfg, feat, thr, is_split, is_num, catcode)
        emit_arr("int", "feat", lf.reshape(-1).tolist(), "0", 16)
        emit_arr(ftype, "thr", [q(v) for v in lt.reshape(-1)], q(0.0))
        emit_arr("unsigned long long", "split",
                 [f"{v}ULL" for v in lsplit], "0ULL")
        if has_cat:
            emit_arr("unsigned long long", "nummask",
                     [f"{v}ULL" for v in lnum], "0ULL")
            emit_arr("int", "catcode", lc.reshape(-1).tolist(), "-1", 16)
    else:
        split_mask = np.zeros(T, dtype=np.uint64)
        num_mask = np.zeros(T, dtype=np.uint64)
        for p in range(NODES):
            split_mask |= is_split[:, p].astype(np.uint64) << np.uint64(p)
            num_mask |= is_num[:, p].astype(np.uint64) << np.uint64(p)
        emit_arr("int", "feat", feat.reshape(-1).tolist(), "0", 16)
        emit_arr(ftype, "thr", [q(v) for v in thr.reshape(-1)], q(0.0))
        emit_arr("unsigned long long", "split",
                 [f"{v}ULL" for v in split_mask], "0ULL")
        if has_cat:
            emit_arr("unsigned long long", "nummask",
                     [f"{v}ULL" for v in num_mask], "0ULL")
            emit_arr("int", "catcode", catcode.reshape(-1).tolist(), "-1", 16)

    emit_arr(ftype, "leaf", [q(v) for v in lv.reshape(-1)], q(0.0))
    h.append(f"static const {ftype} {modelname}_bias[{O}] = {{")
    h.append("    " + _fmt_array([q(v) for v in bias], 8) + "};")
    h.append("")
    h.append(f"static inline void {modelname}_predict("
             f"{acct} *results, const {ftype} *features{sig_cat}) {{")
    h.append("    unsigned int t, d, p, j, go;")
    h.append(f"    for (j = 0; j < {up}_N_OUTPUTS; ++j) "
             f"results[j] = {modelname}_bias[j];")
    h.append(f"    for (t = 0; t < {up}_N_TREES; ++t) {{")
    if etype == "compact":
        # leaf index from level comparison bits: rel = sum_d go_d << (D-1-d)
        # == the heap-walk leaf of ops/predict.py:68-101
        h.append("        p = 0;")
        h.append(f"        for (d = 0; d < {up}_DEPTH; ++d) {{")
        h.append(f"            if (({modelname}_split[t] >> d) & 1ULL) {{")
        cmp_num = (f"features[{modelname}_feat[t * {D} + d]] > "
                   f"{modelname}_thr[t * {D} + d]")
        if has_cat:
            cmp_cat = (f"cat_features[{modelname}_feat[t * {D} + d]] == "
                       f"{modelname}_catcode[t * {D} + d]")
            h.append(f"                go = (({modelname}_nummask[t] >> d) "
                     f"& 1ULL) ? ({cmp_num}) : ({cmp_cat});")
        else:
            h.append(f"                go = {cmp_num};")
            h.append("            } else { go = 0; }")
        if has_cat:
            h.append("            } else { go = 0; }")
        h.append(f"            p |= go << ({up}_DEPTH - 1 - d);")
        h.append("        }")
        leaf_expr = f"(t * {L} + p) * {O} + j"
    else:
        h.append("        p = 0;")
        h.append(f"        for (d = 0; d < {up}_DEPTH; ++d) {{")
        h.append(f"            if (({modelname}_split[t] >> p) & 1ULL) {{")
        cmp_num = (f"features[{modelname}_feat[t * {NODES} + p]] > "
                   f"{modelname}_thr[t * {NODES} + p]")
        if has_cat:
            cmp_cat = (f"cat_features[{modelname}_feat[t * {NODES} + p]] == "
                       f"{modelname}_catcode[t * {NODES} + p]")
            h.append(f"                go = (({modelname}_nummask[t] >> p) "
                     f"& 1ULL) ? ({cmp_num}) : ({cmp_cat});")
        else:
            h.append(f"                go = {cmp_num};")
        h.append("                p = 2 * p + 1 + go;")
        h.append("            } else { p = 2 * p + 1; }")
        h.append("        }")
        leaf_expr = f"(t * {L} + (p - {NODES})) * {O} + j"
    h.append(f"        for (j = 0; j < {up}_N_OUTPUTS; ++j)")
    h.append(f"            results[j] += {modelname}_leaf[{leaf_expr}];")
    h.append("    }")
    h.append("}")

    if has_cat and vocab is not None:
        tables: List[List[bytes]] = vocab.decode_table()
        offs = [0]
        flat: List[bytes] = []
        for tab in tables:
            for entry in tab:
                if b"\x00" in entry:
                    # the emitted encoder compares NUL-terminated C strings;
                    # an embedded NUL would truncate the comparison and
                    # silently encode to the wrong code
                    raise ValueError(
                        "categorical vocabulary entry contains an embedded "
                        f"NUL byte and cannot be exported as a C string "
                        f"literal: {entry!r}")
            flat.extend(tab)
            offs.append(len(flat))
        h.append("")
        h.append("/* Vocabulary encoder: maps raw category strings to the")
        h.append(f"   codes {modelname}_predict expects; -1 = unseen "
                 "(routes left). */")
        h.append(f"static const char *{modelname}_cat_vocab"
                 f"[{max(len(flat), 1)}] = {{")
        h.append("    " + _fmt_array([_c_string(b) for b in flat]
                                     if flat else ['""'], 4) + "};")
        h.append(f"static const int {modelname}_cat_off[{FC + 1}] = {{")
        h.append("    " + _fmt_array([str(v) for v in offs], 16) + "};")
        h.append(f"static inline int {modelname}_cat_code(int feature, "
                 "const char *s) {")
        h.append("    int i, k;")
        h.append(f"    for (i = {modelname}_cat_off[feature]; "
                 f"i < {modelname}_cat_off[feature + 1]; ++i) {{")
        h.append(f"        const char *v = {modelname}_cat_vocab[i];")
        h.append("        for (k = 0; v[k] && v[k] == s[k]; ++k) ;")
        h.append("        if (v[k] == s[k]) "
                 f"return i - {modelname}_cat_off[feature];")
        h.append("    }")
        h.append("    return -1;")
        h.append("}")

    h.append(f"#endif /* {up}_H */")

    if not filename.endswith(".h"):
        filename = filename + ".h"
    with open(filename, "w") as f:
        f.write("\n".join(h) + "\n")
