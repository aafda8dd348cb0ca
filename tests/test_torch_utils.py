"""The port's utils against gbrl_tpu's on the CPU: tree printing and
plotting, metadata, the C-header export (built with the C compiler and
held against the port's predict), the native runtime, the reference
binary format in both directions, and profiling.

Models are grown by gbrl_tpu from a seed (depth 3, 5 features, 8 trees, as
tests/test_c_export.py) and carried into the port through its checkpoint.
"""
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gbrl_tpu.models.gbt import GBTModel as JGBTModel
from gbrl_tpu.utils import profiling as jprof
from gbrl_tpu.utils.reference_import import \
    load_reference_model as j_load_reference

from gbrl_tpu_torch.ensemble import ensemble_to_numpy
from gbrl_tpu_torch.models.gbt import GBTModel
from gbrl_tpu_torch.utils import profiling
from gbrl_tpu_torch.utils.c_runtime import CompiledModel
from gbrl_tpu_torch.utils.reference_import import (load_reference_model,
                                                   parse_reference_file)

GCC = shutil.which("g++") or shutil.which("cc")
N, F, O = 80, 5, 2
KINDS = ("greedy", "oblivious", "categorical", "linear")


def _grow(kind):
    """A JAX GBTModel: 8 trees on 5 numeric features (greedy, oblivious,
    or oblivious with a Linear lr schedule), or 12 fit iterations on one
    numeric and two categorical columns (tests/test_c_export.py)."""
    rng = np.random.default_rng(0)
    if kind == "categorical":
        X = np.empty((120, 3), dtype=object)
        X[:, 0] = rng.uniform(400, 2000, 120).round(2).astype(np.float32)
        X[:, 1] = rng.choice(["2006", "2009", "2015", "2018"], 120)
        X[:, 2] = rng.choice(["sea", "park", "none"], 120)
        y = (X[:, 0].astype(np.float32) * 3 + (X[:, 2] == "sea") * 900
             + rng.normal(0, 40, 120)).astype(np.float32)[:, None]
        m = JGBTModel(tree_struct=dict(max_depth=3, n_bins=8), input_dim=3,
                      output_dim=1, optimizers=dict(algo="SGD", lr=0.7,
                                                    start_idx=0, stop_idx=1),
                      device="cpu")
        m.fit(X, y, 12)
        return m, X
    X = rng.normal(size=(N, F)).astype(np.float32)
    lr = "lin_0.3" if kind == "linear" else 0.3
    m = JGBTModel(tree_struct=dict(max_depth=3, n_bins=8,
                                   grow_policy="greedy" if kind == "greedy"
                                   else "oblivious"),
                  input_dim=F, output_dim=O,
                  optimizers=dict(algo="SGD", lr=lr, T=5, stop_lr=0.01,
                                  start_idx=0, stop_idx=O), device="cpu")
    m.set_bias_from_targets(rng.normal(size=(N, O)))
    for _ in range(8):
        m.step(X, grads=rng.normal(size=(N, O)).astype(np.float32))
    return m, X


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """kind -> (JAX model, port model loaded from its checkpoint, X)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            jm, X = _grow(kind)
            path = str(tmp_path_factory.mktemp("ckpt") / kind)
            jm.save_learner(path)
            cache[kind] = (jm, GBTModel.load_learner(path, device="cpu"), X)
        return cache[kind]
    return get


# ---------------------------------------------------------- introspection
@pytest.mark.parametrize("kind", KINDS[:3])
def test_introspection_matches_jax(pair, kind, tmp_path, capsys,
                                   monkeypatch):
    """print_tree text, the plot's .dot text (no graphviz binary), the
    metadata and the ensemble data: equal to gbrl_tpu's."""
    jm, tm, _ = pair(kind)
    for t in (0, 5, 99):
        jm.print_tree(t)
        want = capsys.readouterr().out
        tm.print_tree(t)
        assert capsys.readouterr().out == want
    assert "node 0: if" in want or "out of range" in want
    monkeypatch.setattr(shutil, "which", lambda name: None)
    jm.plot_tree(3, str(tmp_path / "j"))
    tm.plot_tree(3, str(tmp_path / "t"))
    dot = (tmp_path / "t.dot").read_text()
    assert dot == (tmp_path / "j.dot").read_text()
    assert dot.startswith("digraph tree {")
    assert tm.learner.get_metadata() == jm.learner.get_metadata()
    got, want = tm.learner.get_ensemble_data(), jm.learner.get_ensemble_data()
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k


# -------------------------------------------------------------- C export
PREDICT_MAIN = r"""
#include <stdio.h>
#include "{header}"

int main() {{
    {ftype} features[{n_feat}];
    {acct} results[{n_out}];
    int i, j, n;
    scanf("%d", &n);
    for (i = 0; i < n; ++i) {{
        for (j = 0; j < {n_feat}; ++j) {{
            double v; scanf("%lf", &v);
            features[j] = ({ftype})({scale_expr});
        }}
        {model}_predict(results, features);
        for (j = 0; j < {n_out}; ++j)
            printf("%.9g ", (double)results[j] / {unscale});
        printf("\n");
    }}
    return 0;
}}
"""

CAT_MAIN = r"""
#include <stdio.h>
#include "{header}"

int main() {{
    float features[1];
    int cat_features[2];
    float results[1];
    char buf[2][160];
    int i, j, n;
    scanf("%d", &n);
    for (i = 0; i < n; ++i) {{
        double v; scanf("%lf", &v);
        features[0] = (float)v;
        for (j = 0; j < 2; ++j) {{
            scanf("%159s", buf[j]);
            cat_features[j] = catm_cat_code(j, buf[j]);
        }}
        catm_predict(results, features, cat_features);
        printf("%.9g\n", (double)results[0]);
    }}
    return 0;
}}
"""

FORMATS = {"float": ("float", "float", 1, 1e-4),
           "fxp16": ("int", "long long", 1 << 16, 1e-3),
           "fxp8": ("short", "int", 1 << 8, 0.2)}


def _headers(jm, tm, tmp_path, name, **kw):
    """Both packages' headers for the same options; the port's names its
    generator in the first comment line."""
    jh, th = tmp_path / "j.h", tmp_path / "t.h"
    jm.learner.export(str(jh), name, **kw)
    tm.learner.export(str(th), name, **kw)
    want, got = jh.read_text(), th.read_text()
    assert got.startswith("/* Auto-generated by gbrl_tpu_torch: ")
    return th, got.replace("gbrl_tpu_torch: ", "gbrl_tpu: ", 1), want


def _run(tmp_path, src_text, inp):
    src, exe = tmp_path / "main.c", tmp_path / "main"
    src.write_text(src_text)
    subprocess.run([GCC, "-O2", "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], input=inp.encode(), capture_output=True,
                         check=True)
    return np.array([[float(v) for v in line.split()]
                     for line in out.stdout.decode().strip().splitlines()])


@pytest.mark.skipif(GCC is None, reason="no C compiler")
@pytest.mark.parametrize("policy,etype", [("greedy", "full"),
                                          ("oblivious", "full"),
                                          ("oblivious", "compact")])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_c_export_matches_jax_and_predict(pair, tmp_path, policy, etype,
                                          fmt):
    """The header equals gbrl_tpu's byte for byte (constant lr); built with
    the C compiler it predicts what the port predicts, within
    tests/test_c_export.py's tolerances."""
    jm, tm, X = pair(policy)
    th, got, want = _headers(jm, tm, tmp_path, "gbrl_model",
                             export_format=fmt, export_type=etype)
    assert got == want
    ftype, acct, scale, tol = FORMATS[fmt]
    Xq = X[:16] * (0.05 if fmt == "fxp8" else 1.0)
    inp = f"{len(Xq)}\n" + "\n".join(" ".join(f"{v:.9e}" for v in row)
                                     for row in Xq)
    res = _run(tmp_path, PREDICT_MAIN.format(
        header=th, ftype=ftype, acct=acct, n_feat=F, n_out=O,
        model="gbrl_model", scale_expr=f"v * {scale}" if scale != 1 else "v",
        unscale=float(scale)), inp)
    pred = tm(Xq, requires_grad=False, tensor=False)
    if fmt == "float":
        np.testing.assert_allclose(res, pred, rtol=tol, atol=tol)
    else:
        close = np.abs(res - pred) <= tol + tol * np.abs(pred)
        assert close.mean() >= 0.85, f"only {close.mean():.0%} within tol"


@pytest.mark.skipif(GCC is None, reason="no C compiler")
def test_c_export_categorical_matches_jax(pair, tmp_path):
    """Mixed numeric / categorical: the same header, vocabulary encoder
    included; the built predictor matches the port, unseen value too."""
    jm, tm, X = pair("categorical")
    th, got, want = _headers(jm, tm, tmp_path, "catm")
    assert got == want and "catm_cat_code" in got
    Xq = X[:32].copy()
    Xq[0, 2] = "mountain"          # unseen category -> -1, routes left
    inp = f"{len(Xq)}\n" + "\n".join(f"{r[0]:.9e} {r[1]} {r[2]}" for r in Xq)
    res = _run(tmp_path, CAT_MAIN.format(header=th), inp)
    pred = tm(Xq, requires_grad=False, tensor=False).reshape(-1, 1)
    np.testing.assert_allclose(res, pred, rtol=1e-4, atol=1e-4)


def _split_leaf_table(text):
    """(header before the leaf table, its values, header after it)."""
    head, rest = text.split("gbrl_model_leaf[", 1)
    body, tail = rest.split("};", 1)
    vals = [float(t.strip().rstrip("f")) for t in body.split("{", 1)[1]
            .split(",")]
    return head, np.array(vals, np.float64), tail


def test_c_export_linear_schedule(pair, tmp_path):
    """A Linear schedule folds lr(t) into the leaves: everything but the
    leaf table is byte-equal, and each folded leaf value is within one
    float32 ulp of gbrl_tpu's (XLA may contract the schedule to an FMA)."""
    jm, tm, _ = pair("linear")
    _, got, want = _headers(jm, tm, tmp_path, "gbrl_model")
    (gh, a, gt), (wh, b, wt) = _split_leaf_table(got), _split_leaf_table(want)
    assert gh == wh and gt == wt
    assert a.shape == b.shape and a.size == 8 * 8 * O
    np.testing.assert_array_max_ulp(a.astype(np.float32),
                                    b.astype(np.float32), maxulp=1)


def test_c_export_rejects(tmp_path):
    """The JAX package's ValueErrors: non-SGD optimizers, a bad format or
    type, compact export of greedy or deeper-than-6 trees."""
    def model(policy="oblivious", depth=3, algo="SGD"):
        return GBTModel(tree_struct=dict(max_depth=depth, grow_policy=policy),
                        input_dim=3, output_dim=1,
                        optimizers=dict(algo=algo, lr=0.1, start_idx=0,
                                        stop_idx=1), device="cpu").learner
    h = str(tmp_path / "x.h")
    cases = [(model(algo="Adam"), {}, "SGD"),
             (model(), dict(export_format="int4"), "export_format"),
             (model(), dict(export_type="tiny"), "export_type"),
             (model("greedy"), dict(export_type="compact"), "compact"),
             (model(depth=7), dict(export_type="compact"), "compact")]
    for learner, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            learner.export(h, **kw)


@pytest.mark.skipif(GCC is None, reason="no C compiler")
@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_compiled_model_matches_predict(pair, policy):
    jm, tm, X = pair(policy)
    rt = CompiledModel.from_learner(tm.learner)
    np.testing.assert_allclose(rt(X), tm(X, requires_grad=False,
                                         tensor=False), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt(X[3]), rt(X)[3:4], rtol=0, atol=0)
    with pytest.raises(ValueError, match="numeric-feature"):
        CompiledModel.from_learner(pair("categorical")[1].learner)


# ------------------------------------------------------ reference format
@pytest.mark.parametrize("kind", KINDS)
def test_reference_format_matches_jax(pair, kind, tmp_path):
    """The port writes gbrl_tpu's bytes; gbrl_tpu's file loads into the
    port with equal arrays and predictions; port to port the predictions
    and SHAP values stay (imported counts are path probabilities)."""
    jm, tm, X = pair(kind)
    jp, tp = str(tmp_path / "j.gbrl_model"), str(tmp_path / "t.gbrl_model")
    jm.learner.save_reference_format(jp)
    tm.learner.save_reference_format(tp)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    jl = j_load_reference(jp, device="cpu")
    tl = load_reference_model(jp, device="cpu")
    assert tl.torch_device.type == "cpu"
    got, want = ensemble_to_numpy(tl.ens), jl.ens
    for k in got:
        assert np.array_equal(got[k], np.asarray(getattr(want, k))), k
    x = X[:16]
    np.testing.assert_allclose(tl.predict(x, tensor=False),
                               jl.predict(x, tensor=False),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.predict(x, tensor=False),
                               tm.learner.predict(x, tensor=False),
                               rtol=1e-5, atol=1e-5)
    shap = tm.learner.shap(x)
    np.testing.assert_allclose(tl.shap(x), shap, rtol=1e-5,
                               atol=1e-5 * np.abs(shap).max() + 1e-6)
    assert parse_reference_file(tp)["n_trees"] == tm.get_num_trees()


def test_load_reference_model_defaults_to_cuda(pair, tmp_path, monkeypatch):
    _, tm, _ = pair("greedy")
    path = str(tmp_path / "m.gbrl_model")
    tm.learner.save_reference_format(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_reference_model(path)


# ------------------------------------------------------------- profiling
def test_trace_and_annotate(tmp_path):
    """trace writes one Chrome / TensorBoard trace into logdir, and an
    annotated block shows up among its events."""
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("shap"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "shap" for e in events)


def test_step_timer_report_matches_jax():
    timers = [profiling.StepTimer(), jprof.StepTimer()]
    for tm in timers:
        with tm("rollout"):
            pass
        tm.totals.update(rollout=0.25, update=1.5)
        tm.counts.update(rollout=4, update=3)
    assert timers[0].report() == timers[1].report()
    assert timers[0].report().splitlines()[0].strip().startswith("update:")
    timers[0].reset()
    assert timers[0].report() == ""
