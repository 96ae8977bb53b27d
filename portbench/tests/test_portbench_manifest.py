"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "visionworkbench_tpu"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)


def test_names_and_units_use_only_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[group]}) == len(bench[group])
    texts = [c["why"] for c in bench["configs"] + bench["workloads"]]
    texts += [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]
    texts += bench["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_entries_have_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


def test_moves_names_an_end_to_end_metric_every_listed_cell_reports(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]


def test_run_seconds_fits_the_full_check_budget(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_cells_configurations_and_readers_are_found_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert cell["workload"]["check"]["limits"]
        adapter = harness.load_adapter(cell["config"])
        for fn in ("prepare", "call", "reference", "compare", "item_pixels"):
            assert callable(getattr(adapter, fn))
        assert cell["config"]["reduced"] == next(
            c for c in bench["configs"] if c["name"] == w["config"])["reduced"]
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        for mod in _imports(f):
            assert mod.split(".")[0] != "visionworkbench_torch", (f, mod)
    # nor does what the comparison and the scenes rest on
    for name in ("scenes.py", "roofline.py"):
        for mod in _imports(BENCH / name):
            assert mod.split(".")[0] != "visionworkbench_torch", (name, mod)


def test_forbidden_module_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    import visionworkbench_torch  # noqa: F401  (its name begins with the JAX package's stem)
    for name in ("jaxtyping_like", "visionworkbench_tpu_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = {m.split(".")[0] for m in harness.forbidden_modules()}
    assert not found & {"jaxtyping_like", "visionworkbench_tpu_like", "visionworkbench_torch"}
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in harness.forbidden_modules()
