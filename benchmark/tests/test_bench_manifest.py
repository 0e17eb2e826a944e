"""BENCHMARK.json against the contract's shape and charsets, and the
files it names."""
import json
import os
import re

import pytest

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) \
        and 1 <= bench["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            extra = set(e) - KEYS[section] - (
                {"workloads"} if section in ("end_to_end", "per_layer")
                else set())
            assert set(e) >= KEYS[section] and not extra, (section, e)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_charset(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(run.HERE, "metrics",
                                           m["name"] + ".py"))
    for c in cells:
        reports = [m["name"] for m in run.metrics_of(bench, "end_to_end", c)]
        assert "setup_s" in reports and len(reports) >= 2
        assert run.metrics_of(bench, "per_layer", c)


def test_cells_and_configs(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        entry, config, params = run.cell_files(bench, w["name"])
        assert {"traffic", "check", "trace", "limits"} <= set(params)
        assert os.path.isfile(os.path.join(run.HERE, "systems",
                                           config["system"] + ".py"))
    used = {w["config"] for w in bench["workloads"]}
    for c in configs.values():
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        cfg = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert {"source", "assumed", "reduced", "guarantees"} <= set(cfg)


def test_run_seconds_fit_24_cells(bench):
    """A full check of 24 cells fits the driver's 43200 s."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
