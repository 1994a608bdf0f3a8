"""What the benchmark may import, and BENCHMARK.json against the
contract's shape rules."""
import ast
import json
import math
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    """Top-level names of every module ``path`` imports (relative
    imports count as this package's own)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and re.match(r"^[A-Za-z_][\w.]*:[A-Za-z_]\w*$", node.value)):
            yield node.value.split(":")[0].split(".")[0]    # an ENTRY


def _sources(under):
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(PKG), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Whole top-level names: ``repro_torch`` is not ``repro``."""
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", _sources(PKG / "reference"), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_import_rule_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.cluster\nfrom repro_torch import x\n"
                 "E = 'repro_torch.kernels.ops:sort_kv'\n")
    assert set(_imports(f)) == {"repro_torch"}
    f.write_text("from repro.core import smms\nimport jax.numpy\n")
    assert set(_imports(f)) == {"repro", "jax"}


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check at 24 cells fits 43,200 s
    assert ((2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert all(len(c[k]) <= 200 for k in ("source", "why"))
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"] + SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        mod = (PKG / "metrics" / f"{m['name']}.py").read_text()
        assert f'UNIT = "{m["unit"]}"' in mod
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len(json.dumps(SPEC)) <= 64 * 1024


WIDTH = re.compile(r"(_dim|_rank|_bytes|_cols|_size|_width|dtype)$")


def test_reduced_names_scale_alone():
    """Every key in ``reduced`` is a key of the configuration's file,
    with its reason, and none is a width: a key, record or payload
    width is the source's own."""
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert k in cfg and k in cfg.get("reduced_why", {}), k
            assert not WIDTH.search(k), k


def test_every_cell_reports_what_the_contract_asks():
    from portbench.harness import Bench
    bench = Bench(ROOT)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        mine = bench.metrics_of(w["name"], per_layer=False)
        assert "setup_s" in mine and len(mine) >= 2
        layer = bench.metrics_of(w["name"], per_layer=True)
        assert layer
        for m in SPEC["per_layer"]:
            if m["name"] in layer:
                assert m["moves"] in mine, (w["name"], m["name"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert all(c in {w["name"] for w in SPEC["workloads"]}
                   for c in m["workloads"])


def test_run_seconds_fits_the_full_check():
    rs = SPEC["run_seconds"]
    assert math.floor((43200 - 1200 - 24 * 180) / (2 + 14 * 24) - 60) >= rs
