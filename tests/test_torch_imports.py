"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never continue on the CPU when CUDA was asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ctc_pytorch_tpu_torch"
FORBIDDEN = ("jax", "ctc_pytorch_tpu")


def _forbidden(name: str) -> bool:
    # exact name or dotted prefix: ``ctc_pytorch_tpu_torch`` itself is fine
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_static_scan_finds_no_forbidden_import():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_forbidden_name_match_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("ctc_pytorch_tpu") and _forbidden("ctc_pytorch_tpu.vocab")
    assert not _forbidden("ctc_pytorch_tpu_torch.vocab")
    assert not _forbidden("jaxtyping")


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in {forbidden!r}):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import ctc_pytorch_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    ctc_pytorch_tpu_torch.__path__, "ctc_pytorch_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import ctc_pytorch_tpu_torch.cli.test
import chip_smoke
leaked = [m for m in sys.modules
          if any(m == f or m.startswith(f + ".") for f in {forbidden!r})]
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_under_a_blocker():
    code = _BLOCKED_IMPORT.format(forbidden=FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 15


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_a_card(no_card):
    from ctc_pytorch_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda_and_raise_without_a_card(
        no_card, tmp_path):
    from ctc_pytorch_tpu_torch.cli.test import evaluate
    from ctc_pytorch_tpu_torch.config import Config
    from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package

    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_package(tmp_path / "missing.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(Config(), str(tmp_path / "missing.npz"))


def test_lstm_wrapper_has_no_fallback_for_other_devices():
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops

    gx = torch.zeros(2, 1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_ops.lstm_bidir(gx, torch.zeros(2, 4, 16, device="meta"))
