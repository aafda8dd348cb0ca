"""gbrl_tpu_torch stands alone: no jax, no gbrl_tpu, and no silent CPU
fallback when CUDA is asked for without a card."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gbrl_tpu_torch
from gbrl_tpu_torch.common.utils import resolve_device

PKG = Path(gbrl_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gbrl_tpu")


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
