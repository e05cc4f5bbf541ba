"""What the benchmark imports, and how it finds its parts by name.

Imports are compared by their top-level name, whole: ``jax``, ``jaxlib``,
``flax`` and the JAX package ``ctc_pytorch_tpu`` are refused everywhere
under ``gpubench/``; the port ``ctc_pytorch_tpu_torch`` is allowed in the
harness and refused in ``gpubench/reference/``.
"""

import ast
import json
from pathlib import Path

import pytest

from gpubench import harness, registry

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ctc_pytorch_tpu"}
PORT = "ctc_pytorch_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_and_a_plain_reference(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if "reference" in path.relative_to(HERE).parts:
        assert PORT not in names, f"{path} imports the port"


def test_the_scan_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import ctc_pytorch_tpu_torch.ops\nimport jax.numpy\n"
                   "from ctc_pytorch_tpu.models import x\n")
    assert top_level_imports(src) == {PORT, "jax", "ctc_pytorch_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "ctc_pytorch_tpu_torch_like",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jaxlib.xla"]


@pytest.mark.parametrize("name", ["timit_lstm-train_b8", "a.b-c_9", "_x",
                                  "9" * 64])
def test_valid_names(name):
    assert registry.check_name(name) == name


@pytest.mark.parametrize("name", ["", "a b", "a,b", "a/b", "-a", ".a",
                                  "ä", "µs", "x" * 65, "a\tb"])
def test_invalid_names(name):
    with pytest.raises(ValueError):
        registry.check_name(name)


@pytest.mark.parametrize("unit", ["utt/s", "%", "ms", "tokens/s", "s",
                                  "GB.x-1_"])
def test_valid_units(unit):
    assert registry.check_unit(unit) == unit


@pytest.mark.parametrize("unit", ["", "tokens per s", "x" * 17, "µs", "a,b"])
def test_invalid_units(unit):
    with pytest.raises(ValueError):
        registry.check_unit(unit)


BENCH = registry.load_benchmark()
NUMBERS = {"loss_gap", "grad_norm_gap", "step_norm_gap", "grad_error",
           "align_gap_nats", "passes_differing"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(cell):
    job, entry = harness.make_job(BENCH, cell, 1, 1.0, False, "cpu", 0.0)
    assert registry.kind(job.mix["kind"]).run
    assert job.limits and set(job.limits) <= NUMBERS
    for m in registry.metrics_for(BENCH, cell, "per_layer"):
        assert callable(registry.metric_reader(m["name"]).read)
    assert registry.metrics_for(BENCH, cell, "end_to_end")
    conf = registry.config(entry["config_entry"])
    assert sorted(conf["changed"]) == sorted(entry["config_entry"]["reduced"])


def test_kernel_tables_by_layer():
    tables = registry.kernel_tables()
    assert "fwd_fma_kernel" in tables["recurrence"]
    assert "prepass_tf32_kernel" in tables["recurrence"]
    assert tables["ctc"] == ["ctc_fwd_kernel", "ctc_bwd_kernel"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.cell(BENCH, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_mix")
    with pytest.raises(FileNotFoundError):
        registry.metric_reader("no_such.metric")
    with pytest.raises(ValueError):
        registry.traffic("../configs/timit_lstm")


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = registry.metrics_for(BENCH, w["name"], "end_to_end")
        assert len(reported) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024
