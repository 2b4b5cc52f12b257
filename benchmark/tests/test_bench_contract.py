"""BENCHMARK.json within the contract's limits, every name resolved to its
file, a new configuration, mix and metric found by name alone, and the
imports of the yardstick."""

import ast
import json
import os
import re
import shutil

import pytest

from conftest import REPO
from helpers import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = os.path.join(REPO, "benchmark")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units_are_within_the_contract():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert all(line_ok(w) for w in b["command"]) and len(b["command"]) <= 32
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_resolves_to_its_file():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        for key in ("darknet_cfg", "learnet_cfg"):
            if key in cfg:
                assert cfg[key].startswith("benchmark/configs/cfg/")
                assert os.path.exists(os.path.join(REPO, cfg[key]))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        for entry in limits.values():
            assert entry["lower"] < entry["limit"] < entry["upper"]
            assert entry["upper"] >= 3 * entry["lower"]
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))


def test_cfg_copies_are_the_published_ones():
    for name in ("darknet_dynamic.cfg", "reweighting_net.cfg", "yolo-voc.cfg"):
        with open(os.path.join(BENCH, "configs", "cfg", name)) as f, \
                open(os.path.join(REPO, "cfg", name)) as g:
            assert f.read() == g.read()


def test_new_config_mix_and_metric_are_found_by_name(tiny_root):
    b = os.path.join(tiny_root, "benchmark")
    shutil.copy(os.path.join(b, "configs", "yolov2_voc.json"),
                os.path.join(b, "configs", "yolov2_new.json"))
    with open(os.path.join(b, "traffic", "train_b64.json")) as f:
        mix = json.load(f)
    with open(os.path.join(b, "traffic", "train_b2.json"), "w") as f:
        json.dump(dict(mix, batch=2), f)
    with open(os.path.join(b, "metrics", "steps_counted.train.py"), "w") as f:
        f.write('"""Steps of the untraced window."""\n\n\ndef read(rec):\n'
                '    return rec.get("steps")\n')
    shutil.copy(os.path.join(b, "limits", "yolov2_voc.train_b64.json"),
                os.path.join(b, "limits", "yolov2_new.train_b2.json"))
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        data = json.load(f)
    data["configs"].append({"name": "yolov2_new", "source": "https://example.org/new",
                            "file": "benchmark/configs/yolov2_new.json", "reduced": [],
                            "why": "a new configuration"})
    data["workloads"].append({"name": "yolov2_new.train_b2", "config": "yolov2_new",
                              "traffic": "train_b2", "chips": 1, "why": "a new cell"})
    for m in data["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("yolov2_new.train_b2")
    data["per_layer"].append({"name": "steps_counted.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "train step",
                              "moves": "train_img_s", "workloads": ["yolov2_new.train_b2"]})
    with open(path, "w") as f:
        json.dump(data, f)
    result, status = run_cell(tiny_root, "yolov2_new.train_b2", trace=1)
    assert status["rc"] == 0
    assert result["metrics"]["steps_counted.train"]["value"] >= 1
    assert "step_mfu_pct.train" not in result["metrics"]  # its list does not name the cell
    result, _ = run_cell(tiny_root, "yolov2_new.train_b2")
    assert set(result["metrics"]) == {"train_img_s", "setup_s"}


def imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources("")))
def test_nothing_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imports_of(path)}
    assert not tops & {"jax", "jaxlib", "flax", "fewshot_detection_tpu"}


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imports_of(path)}
    assert tops <= {"__future__", "gzip", "numpy", "torch"}, tops
