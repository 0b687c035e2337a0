"""``BENCHMARK.json`` against the benchmark's contract: names, units and
free text within their characters, every file found by name, every cell
reporting ``setup_s``, another end-to-end metric and a per-layer one."""
import json
import re

from portbench import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    spec = harness.manifest()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and c["reduced"] == []
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "name"] == c["name"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] == 1 and line_ok(w["why"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in spec["end_to_end"] if m["name"] == "setup_s"]
    names = [x["name"] for x in spec["configs"] + spec["workloads"]
             + spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    spec = harness.manifest()
    for w in spec["workloads"]:
        e2e = [m["name"] for m in spec["end_to_end"]
               if harness.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in spec["per_layer"]
                  if harness.applies(m, w["name"])]
        assert layers
        for m in layers:
            assert m["moves"] in e2e and line_ok(m["layer"])
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
            assert callable(harness.reader(m["name"]))
        assert any("mfu" in m["name"] for m in layers)


def test_layers_named_alike():
    spec = harness.manifest()
    by_layer = {}
    for m in spec["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(
            m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
