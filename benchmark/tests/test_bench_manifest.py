"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from benchmark.manifest import ROOT, Cell, entry, manifest, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token")


def test_keys_and_sizes():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    # a full check of 24 cells has to fit in 43200 s
    cells = 24
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_names_units_and_entries():
    b = manifest()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        for x in b[group]:
            assert set(x) == keys
            assert NAME.match(x["name"])
            assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and 1 <= len(
            c["source"]) <= 200
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert 1 <= len(m["layer"]) <= 200
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_cell_reports_what_it_must():
    b = manifest()
    for w in b["workloads"]:
        cell = Cell(w["name"], b)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_files_found_by_name():
    b = manifest()
    for w in b["workloads"]:
        cell = Cell(w["name"], b)
        assert cell.config["name"] == w["config"]
        assert set(cell.limits["numbers"]) >= {"infeasible", "obj_err",
                                               "select_diff"}
        assert callable(entry(cell.traffic["entry"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        Cell("no-such-cell")


def test_command_names_no_file_outside_paths():
    b = manifest()
    assert b["command"][:2] == ["python3", "-m"]
    mod = b["command"][2]
    assert os.path.exists(os.path.join(ROOT, *mod.split(".")) + ".py")
    assert any(mod.replace(".", "/").startswith(p) for p in b["paths"])


def test_config_files_are_json():
    for c in manifest()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
