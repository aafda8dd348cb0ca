"""gbrl_tpu_torch stands alone: no jax, no gbrl_tpu, and no silent CPU
fallback when CUDA is asked for without a card; and it is whole: every
public function, class and method of gbrl_tpu has a counterpart of the same
name in the same module of the port, apart from the exceptions listed
below with their reasons."""
import ast
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gbrl_tpu_torch
from gbrl_tpu_torch.common.utils import resolve_device

PKG = Path(gbrl_tpu_torch.__file__).resolve().parent
JAX_PKG = PKG.parent / "gbrl_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "gbrl_tpu")

# gbrl_tpu module -> the port's module of another name
MODULES = {"ops/pallas_kernels.py": "ops/kernels.py"}
# gbrl_tpu modules with no counterpart, and why
NO_MODULE = {
    "csrc/__init__.py": "only a docstring pointing at utils/c_runtime.py "
                        "and c_export.py; the port's csrc/ holds the CUDA "
                        "and C sources, which are not a Python package",
}
# (gbrl_tpu module, name) with no counterpart, and why
NOT_PORTED = {
    ("__init__.py", "tpu_available"):
        "a TPU probe; cuda_available takes its place",
    ("ops/pallas_kernels.py", "hist_vmem_bytes"):
        "K2's TPU VMEM guard; K2's launch plan (_hist_plan) sizes its "
        "shared memory",
    ("ops/pallas_kernels.py", "tree_vmem_bytes"):
        "K6's TPU VMEM guard; K6's launch plan (_tree_plan) sizes its "
        "shared memory",
}
# suffix in gbrl_tpu -> suffix in the port: the TPU kernels' wrappers are
# the Hopper kernels' wrappers, and functions named after JAX are named
# after PyTorch
RENAMES = (("_pallas", "_cuda"), ("_jax", "_torch"))


def test_import_leaves_jax_and_gbrl_tpu_out():
    code = ("import sys, gbrl_tpu_torch, gbrl_tpu_torch.ops.kernels, "
            "gbrl_tpu_torch.models; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_gbrl_tpu(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_cuda_request_without_card_raises(monkeypatch):
    from gbrl_tpu_torch import ActorCritic, SharedActorCriticLearner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SharedActorCriticLearner(4, 3, {}, dict(start_idx=0, stop_idx=2),
                                 dict(start_idx=2, stop_idx=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActorCritic({}, 4, 3, dict(start_idx=0, stop_idx=2),
                    dict(start_idx=2, stop_idx=3), device="cuda:0")
    assert resolve_device("cpu").type == "cpu"
    assert not gbrl_tpu_torch.cuda_available()


def test_kernel_build_dir(monkeypatch, tmp_path):
    """Source checkout: build/ at its root; an override wins; an installed
    package (no pyproject.toml beside it) builds under the user cache."""
    from gbrl_tpu_torch.ops import kernels as K
    root = Path(K.__file__).resolve().parents[2]
    monkeypatch.delenv("GBRL_TPU_TORCH_BUILD_DIR", raising=False)
    assert K.build_dir() == root / "build" / "gbrl_tpu_torch_kernels"
    monkeypatch.setenv("GBRL_TPU_TORCH_BUILD_DIR", str(tmp_path / "k"))
    assert K.build_dir() == tmp_path / "k"
    monkeypatch.delenv("GBRL_TPU_TORCH_BUILD_DIR")
    site = tmp_path / "site-packages" / "gbrl_tpu_torch" / "ops"
    monkeypatch.setattr(K, "__file__", str(site / "kernels.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert K.build_dir() == tmp_path / "cache" / "gbrl_tpu_torch_kernels"


def _public(name: str) -> bool:
    return not name.startswith("_")


def _top_level(path: Path):
    """A module's top-level functions and classes, each class's own
    methods, and the names its top-level assignments bind."""
    defs, methods, assigned = set(), {}, set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.add(node.name)
        elif isinstance(node, ast.ClassDef):
            defs.add(node.name)
            methods[node.name] = [
                m.name for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            assigned.update(t.id for t in targets if isinstance(t, ast.Name))
    return defs, methods, assigned


def _defined(path: Path):
    """Every name a module defines itself (not by import)."""
    defs, _, assigned = _top_level(path)
    return defs | assigned


def _port_name(name: str) -> str:
    for jax_suffix, port_suffix in RENAMES:
        if name.endswith(jax_suffix):
            return name[:-len(jax_suffix)] + port_suffix
    return name


def _has_method(cls, name: str) -> bool:
    """``cls`` defines or inherits a method (or property) ``name``."""
    attr = inspect.getattr_static(cls, name, None)
    return isinstance(attr, (staticmethod, classmethod, property)) or \
        inspect.isfunction(attr)


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    """Each public top-level function and class of the gbrl_tpu module is
    defined in the port's module of the same path (renamed as RENAMES
    says), and each public method of a class there is defined or
    inherited by the port's class."""
    if module in NO_MODULE:
        assert not (PKG / module).exists()
        return
    port_file = PKG / MODULES.get(module, module)
    assert port_file.exists(), f"no counterpart of gbrl_tpu/{module}"
    names, methods, _ = _top_level(JAX_PKG / module)
    port_names = _defined(port_file)
    dotted = str(port_file.relative_to(PKG.parent).with_suffix(""))
    port_mod = importlib.import_module(
        dotted.replace("/", ".").removesuffix(".__init__"))
    missing = []
    for name in sorted(filter(_public, names)):
        want = _port_name(name)
        if (module, name) in NOT_PORTED:
            continue
        if want not in port_names:
            missing.append(want)
        elif name in methods:
            cls = getattr(port_mod, want)
            missing += [f"{want}.{m}" for m in methods[name]
                        if _public(m) and not _has_method(cls, m)]
    assert not missing, f"gbrl_tpu/{module}: the port lacks {missing}"


@pytest.mark.parametrize("module,name", sorted(NOT_PORTED))
def test_exceptions_are_still_needed(module, name):
    """Every listed exception names a public gbrl_tpu name that the port
    does not define, so the list cannot go stale."""
    names, _, _ = _top_level(JAX_PKG / module)
    port_names = _defined(PKG / MODULES.get(module, module))
    assert name in names and _port_name(name) not in port_names
