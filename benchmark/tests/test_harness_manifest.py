"""``BENCHMARK.json`` and the files its names point to."""

from __future__ import annotations

import ast
import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[part]:
            assert set(entry) <= KEYS[part], (part, entry)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert MANIFEST["paths"] == ["benchmark"]


def test_names_and_units_use_the_allowed_characters():
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[part]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
    for c in MANIFEST["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(w) for w in MANIFEST["command"])
    assert len(names) == len(set(names))


def test_metric_rules():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for w in cells:
        reported = [n for n, m in e2e.items() if w in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, w
        assert any(w in m["workloads"] for m in MANIFEST["per_layer"]), w
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_finds_its_files_by_name():
    from harness import load_cell

    for w in MANIFEST["workloads"]:
        cell = load_cell(w["name"], ROOT)
        assert cell.cfg["family"] and cell.traffic["kind"]
        importlib.import_module(f"families.{cell.cfg['family']}")
        importlib.import_module(f"kinds.{cell.traffic['kind']}")
    for path in (BENCH / "traffic").glob("*.json"):
        importlib.import_module(f"kinds.{json.loads(path.read_text())['kind']}")
    for path in (BENCH / "metrics").glob("*.py"):
        if path.stem != "__init__":
            assert callable(importlib.import_module(f"metrics.{path.stem}").read)
        assert cell.limits
        for m in cell.per_layer:
            assert callable(importlib.import_module(f"metrics.{m['name']}").read)
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert {"source", "assumed", "reduced", "frames", "keypoints", "members", "cameras"} <= set(cfg)


def test_an_added_configuration_and_mix_are_taken_with_no_edit(tmp_path):
    """A later cell is new files and new manifest entries only."""
    from harness import load_cell

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "singlecam-10k-k20.json").read_text())
    cfg["keypoints"] = 100
    (root / "benchmark" / "configs" / "singlecam-10k-k100.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "auto-s-serial.json").read_text())
    mix["pool"] = 3
    (root / "benchmark" / "traffic" / "auto-s-pool3.json").write_text(json.dumps(mix))
    (root / "benchmark" / "checks" / "singlecam-k100-auto.json").write_text(
        (BENCH / "checks" / "singlecam-auto.json").read_text())
    manifest["configs"].append({"name": "singlecam-10k-k100", "source": "s", "why": "w", "reduced": [],
                                "file": "benchmark/configs/singlecam-10k-k100.json"})
    manifest["workloads"].append({"name": "singlecam-k100-auto", "config": "singlecam-10k-k100",
                                  "traffic": "auto-s-pool3", "chips": 1, "why": "w"})
    for m in manifest["end_to_end"][1:3] + manifest["per_layer"][:3]:
        m["workloads"].append("singlecam-k100-auto")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = load_cell("singlecam-k100-auto", root)
    assert cell.cfg["keypoints"] == 100 and cell.traffic["pool"] == 3
    assert cell.kp_frames == 100 * 10_000
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "kp_frames_per_s", "job_p90_s"]
    assert [m["name"] for m in cell.per_layer] == ["prep_ms", "package_ms", "adam_iter_ms"]


def test_roofline_reproduces_the_recorded_bounds():
    import roofline

    assert roofline.paired_nll_bound_ms(20, 10_000, 2, 2) == (pytest.approx(0.00119, rel=5e-3), "operations")
    assert roofline.filter_scan_bound_ms(20, 10_000, 2) == (pytest.approx(0.00764, rel=5e-3), "bytes")
    assert roofline.smoother_scan_bound_ms(20, 10_000, 2)[0] == pytest.approx(0.00478, rel=5e-3)
    assert roofline.paired_nll_bound_ms(10, 10_000, 3, 4)[0] == pytest.approx(0.00250, rel=5e-3)
    assert roofline.filter_scan_bound_ms(10, 10_000, 3)[0] == pytest.approx(0.00788, rel=5e-3)


# ---- the import guard -------------------------------------------------------
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "eks_tpu"}


def _imported_top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    names = _imported_top_names(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "eks_tpu_torch" not in names


def test_the_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import eks_tpu.core\nfrom jax import numpy\nimport eks_tpu_torch\n")
    assert _imported_top_names(bad) & FORBIDDEN == {"eks_tpu", "jax"}


def test_a_run_refuses_a_forbidden_module(monkeypatch):
    import sys
    import types

    import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "eks_tpu_torchish", types.ModuleType("eks_tpu_torchish"))
    assert harness.forbidden_modules() == ["jax"]
