"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never continue on the CPU when CUDA was asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    assert len(files) > 25
    names = {str(p.relative_to(ROOT)) for p in files}
    for new in ("ops/ctc_loss.py", "ops/lstm_bidir_train.py", "ops/_build.py",
                "train/loop.py", "train/state.py", "train/scheduler.py",
                "train/metrics_log.py", "cli/train.py", "ops/gru_bidir.py",
                "ops/gru_bidir_train.py", "ops/stacked.py", "ops/rnn_bidir.py",
                "ops/rnn_bidir_train.py", "decode/beam.py",
                "decode/beam_device.py", "decode/ngram_lm.py",
                "cli/train_lm.py", "native/__init__.py",
                "frontend/features.py", "frontend/cmvn.py", "frontend/splice.py",
                "frontend/fmel.py", "frontend/e2e.py", "data/prep/sphere.py",
                "data/prep/shorten.py", "cli/make_feat.py", "api.py",
                "data/prep/timit.py", "data/prep/phones.py", "cli/run.py",
                "data/convert.py", "cli/import_torch.py", "cli/visualize.py",
                "utils.py", "parallel/__init__.py", "parallel/distributed.py",
                "parallel/mesh.py"):
        assert f"ctc_pytorch_tpu_torch/{new}" in names
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
import ctc_pytorch_tpu_torch.cli.train
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
    assert int(proc.stdout.split()[-1]) > 25


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


def test_training_entry_points_raise_without_a_card(no_card, tmp_path):
    from ctc_pytorch_tpu_torch.cli import train as cli_train
    from ctc_pytorch_tpu_torch.config import CNNConfig, Config
    from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
    from ctc_pytorch_tpu_torch.train.loop import Trainer
    from ctc_pytorch_tpu_torch.train.state import create_train_state

    cfg = Config()
    cfg.checkpoint_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.train(cfg)
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--conf", str(conf)])
    spec = ModelSpec(add_cnn=False, cnn=CNNConfig(), rnn_input_size=4,
                     rnn_hidden_size=4, rnn_layers=1, rnn_cell="lstm",
                     bidirectional=True, batch_norm=False, num_class=3,
                     drop_out=0.0, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(spec, 1e-3)
    assert not list(tmp_path.glob("**/*.npz"))


def test_kernel_modules_build_nothing_at_import():
    from ctc_pytorch_tpu_torch.ops import _build, ctc_loss, lstm_bidir_train
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops

    for lib in (lstm_ops.LIBRARY, lstm_bidir_train.LIBRARY, ctc_loss.LIBRARY):
        assert lib._lib is None and lib.source.exists()
        assert all(h.exists() for h in lib.headers)
        assert lib.output_path().parent == _build.BUILD_DIR
    # a header is part of the version: both LSTM sources include the
    # forward's cluster header, which includes lstm_fwd.cuh (the grid), the
    # hoisted backward's header, gru_fwd.cuh and the wide branch's header
    fwd = ["lstm_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh", "gru_fwd.cuh",
           "fwd_wide.cuh", "fwd_cluster.cuh"]
    assert [h.name for h in lstm_ops.LIBRARY.headers] == fwd
    assert [h.name for h in lstm_bidir_train.LIBRARY.headers] == fwd
    for lib in (lstm_ops.LIBRARY, lstm_bidir_train.LIBRARY):
        assert '#include "fwd_cluster.cuh"' in lib.source.read_text()
    assert '#include "bwd_hoist.cuh"' in lstm_bidir_train.LIBRARY.source.read_text()
    cluster = (_build.CSRC / "fwd_cluster.cuh").read_text()
    for inc in ("bwd_hoist.cuh", "gru_fwd.cuh", "fwd_wide.cuh"):
        assert f'#include "{inc}"' in cluster
    # the forward entries name their branch first and report it
    for lib, prefix in ((lstm_ops.LIBRARY, "lstm_bidir"),
                        (lstm_bidir_train.LIBRARY, "lstm_bidir_train")):
        assert {f"{prefix}_fwd_branch", f"{prefix}_forward"} <= set(lib.functions)
    assert _build.FWD_BRANCHES == ("grid", "cluster16", "cluster32",
                                   "cluster16_fp32", "wide_fp32", "wide_bf16")


def test_gru_kernel_modules_build_nothing_at_import():
    from ctc_pytorch_tpu_torch.ops import _build, gru_bidir, gru_bidir_train, stacked

    # the headers are part of the version: gru_fwd.cuh includes
    # lstm_fwd.cuh; the forward's source includes the cluster header (which
    # includes gru_fwd.cuh and bwd_hoist.cuh), the backward's gru_fwd.cuh
    # and bwd_hoist.cuh
    for lib, source, headers, inc in (
            (gru_bidir.LIBRARY, "gru_bidir.cu",
             ["lstm_fwd.cuh", "gru_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh",
              "fwd_wide.cuh", "fwd_cluster.cuh"],
             "fwd_cluster.cuh"),
            (gru_bidir_train.LIBRARY, "gru_bidir_train.cu",
             ["lstm_fwd.cuh", "gru_fwd.cuh", "bwd_hoist.cuh", "bwd_wide.cuh"],
             "gru_fwd.cuh")):
        assert lib._lib is None and lib.source.name == source
        assert lib.source.exists() and all(h.exists() for h in lib.headers)
        assert lib.output_path().parent == _build.BUILD_DIR
        assert [h.name for h in lib.headers] == headers
        assert f'#include "{inc}"' in lib.source.read_text()
    assert {"gru_bidir_fwd_branch", "gru_bidir_forward"} <= set(
        gru_bidir.LIBRARY.functions)
    assert '#include "lstm_fwd.cuh"' in (_build.CSRC / "gru_fwd.cuh").read_text()
    assert '#include "lstm_fwd.cuh"' in (_build.CSRC / "bwd_hoist.cuh").read_text()
    # the trainable op's forward is the eval library's kernel; the backward
    # is a pre-pass and a serial launch, whose branch the library names first
    assert set(gru_bidir_train.LIBRARY.functions) == {
        "gru_bidir_train_bwd_prepass", "gru_bidir_train_bwd_branch",
        "gru_bidir_train_bwd_wide_scratch", "gru_bidir_train_backward",
        "gru_bidir_train_error_string"}
    assert not hasattr(stacked, "LIBRARY")  # wrappers: no kernel of their own


def test_rnn_kernel_modules_build_nothing_at_import():
    from ctc_pytorch_tpu_torch.ops import _build, rnn_bidir, rnn_bidir_train

    for lib, source in ((rnn_bidir.LIBRARY, "rnn_bidir.cu"),
                        (rnn_bidir_train.LIBRARY, "rnn_bidir_train.cu")):
        assert lib._lib is None and lib.source.name == source
        assert lib.source.exists() and all(h.exists() for h in lib.headers)
        assert lib.output_path().parent == _build.BUILD_DIR
        # every csrc/ header the source reaches is part of the version: the
        # grid branch's rnn_fwd.cuh (over lstm_fwd.cuh) and the cluster
        # branches' fwd_cluster.cuh (over bwd_hoist.cuh, gru_fwd.cuh and
        # fwd_wide.cuh)
        assert {h.name for h in lib.headers} == included(lib.source) == {
            "lstm_fwd.cuh", "rnn_fwd.cuh", "gru_fwd.cuh", "bwd_hoist.cuh",
            "bwd_wide.cuh", "fwd_wide.cuh", "fwd_cluster.cuh"}
        assert '#include "rnn_fwd.cuh"' in lib.source.read_text()
    assert '#include "lstm_fwd.cuh"' in (_build.CSRC / "rnn_fwd.cuh").read_text()
    # the trainable op's forward is the eval library's kernel; its own
    # library has the backward and the backward's branch
    assert set(rnn_bidir_train.LIBRARY.functions) == {
        "rnn_bidir_train_bwd_branch", "rnn_bidir_train_backward",
        "rnn_bidir_train_error_string"}
    assert set(rnn_bidir.LIBRARY.functions) == {
        "rnn_bidir_fwd_branch", "rnn_bidir_forward", "rnn_bidir_error_string"}


def included(source):
    """Names of the csrc/ headers that ``source`` includes, transitively."""
    import re

    seen, todo = set(), [source]
    while todo:
        for name in re.findall(r'#include "([^"]+)"', todo.pop().read_text()):
            if name not in seen:
                seen.add(name)
                todo.append(source.parent / name)
    return seen


def test_no_kernel_source_calls_a_library_for_the_recurrent_products():
    from ctc_pytorch_tpu_torch.ops import _build

    sources = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))
    assert {p.name for p in sources} >= {
        "bwd_hoist.cuh", "fwd_cluster.cuh", "gru_bidir.cu", "gru_bidir_train.cu",
        "gru_fwd.cuh", "lstm_bidir.cu",
        "lstm_bidir_train.cu", "lstm_fwd.cuh", "ctc_dp.cu", "rnn_bidir.cu",
        "rnn_bidir_train.cu", "rnn_fwd.cuh"}
    for path in sources:
        text = path.read_text()
        includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
        for banned in ("cublas", "cudnn", "cutlass", "torch/", "ATen"):
            assert not any(banned in ln for ln in includes), (path.name, banned)


def test_native_search_builds_its_own_library_and_nothing_at_import():
    """The port's host beam search compiles its own copy of the C++ source
    into its git-ignored build directory; it never loads the JAX package's
    library."""
    from ctc_pytorch_tpu_torch import native

    assert native.SOURCE == PORT / "native" / "ctc_native.cpp"
    assert native.library_path().parent == PORT / "native" / "build"
    assert "ctc_pytorch_tpu_torch/native/build/" in (
        ROOT / ".gitignore").read_text().splitlines()
    for path in _port_files():  # the JAX package's library's name
        assert "libctc_native.so" not in path.read_text(), path
    code = ("import ctc_pytorch_tpu_torch.native as n, "
            "ctc_pytorch_tpu_torch.decode.beam; assert n._lib is None")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_native_ark_reader_is_the_ports_copy_and_builds_nothing_at_import():
    """The one-pass ark reader compiles the port's copy of
    ``ark_native.cpp`` into the same git-ignored library as the beam
    search, whose name carries a digest of both sources; importing the
    dataset or the CLIs that read features builds nothing."""
    from ctc_pytorch_tpu_torch import native

    assert native.ARK_SOURCE == PORT / "native" / "ark_native.cpp"
    assert native._sources() == (native.SOURCE, native.ARK_SOURCE)
    text = native.ARK_SOURCE.read_text()
    for fn in ("ark_open", "ark_close", "ark_dims_fd", "ark_load_processed_fd"):
        assert f"int {fn}(" in text or f"void {fn}(" in text, fn
    code = ("import ctc_pytorch_tpu_torch.native as n, "
            "ctc_pytorch_tpu_torch.data.dataset, ctc_pytorch_tpu_torch.cli.run, "
            "ctc_pytorch_tpu_torch.cli.visualize, "
            "ctc_pytorch_tpu_torch.cli.import_torch; "
            "assert n._lib is None and not n._ark_fds")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_lstm_wrapper_has_no_fallback_for_other_devices():
    from ctc_pytorch_tpu_torch.ops import lstm_bidir as lstm_ops

    gx = torch.zeros(2, 1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_ops.lstm_bidir(gx, torch.zeros(2, 4, 16, device="meta"))


def test_waveform_entry_points_raise_without_a_card(no_card, tmp_path):
    """Stage 1, the waveform frontend's feature extraction and the
    ``Recognizer`` default to ``cuda`` and raise without a card, before
    any file is written."""
    from ctc_pytorch_tpu_torch.api import Recognizer
    from ctc_pytorch_tpu_torch.cli import make_feat
    from ctc_pytorch_tpu_torch.frontend import FrontendConfig
    from ctc_pytorch_tpu_torch.vocab import Vocab

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_feat.main(["fbank", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_feat.extract_features(np.zeros(16000, np.float32), "fbank",
                                   FrontendConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(tmp_path / "missing.npz", Vocab.from_units(["a"]))
    assert not list(tmp_path.iterdir())
