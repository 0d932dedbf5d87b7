"""``BENCHMARK.json`` keeps to the benchmark's contract (names, units, keys,
the metrics each cell reports), every name in it resolves to a file under
``ttsbench/``, and a new cell, configuration, traffic mix and per-layer
metric can be added as new files and entries, with no file edited."""

import json
import pathlib
import re
import shutil

import pytest

from ttsbench.lib.cells import Cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(CELLS) <= 24 and 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128 and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_units_and_one_line_fields():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("ttsbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} == ({"name", "unit", "better", "bound", "source"}
                                          if m in BENCH["end_to_end"] else
                                          {"name", "unit", "better", "source", "layer", "moves"})
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])


def _reported(cell):
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and m["moves"] in _reported(cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_per_layer_metric():
    for cell in CELLS:
        assert "setup_s" in _reported(cell) and len(_reported(cell)) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves_to_its_files(cell):
    c = Cell(cell)
    assert callable(c.kind.run) and callable(c.kind.control)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    assert set(c.spec["limits"]) >= {"length_mismatches"} or "loss_gap" in c.spec["limits"]


def test_a_new_cell_config_mix_and_metric_are_files_and_entries(tmp_path):
    """In a copy: a configuration, a cell with its own mix, a traffic kind
    and a per-layer metric added as new files and entries; nothing existing
    is edited."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "ttsbench", root / "ttsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "ttsbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "ttsbench/configs/fs2-hifigan-v3.json").read_text())
    cfg["name"] = "dummy-config"
    (root / "ttsbench/configs/dummy-config.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "ttsbench/workloads/v3-batch.json").read_text())
    spec.update(config="dummy-config", traffic="dummy-mix")
    spec["params"]["texts_per_call"] = 32
    spec["kind"] = "dummy_kind"
    (root / "ttsbench/workloads/dummy-cell.json").write_text(json.dumps(spec))
    (root / "ttsbench/traffic/dummy_kind.py").write_text(
        "def run(run):\n    pass\n\n\ndef control(cell, seed, device, variant, seconds):\n"
        "    return {}\n")
    (root / "ttsbench/metrics/dummy_texts.dummy.py").write_text(
        "def read(ctx):\n    return ctx.get('texts')\n")
    bench["configs"].append({"name": "dummy-config", "source": "https://example.org/dummy",
                             "file": "ttsbench/configs/dummy-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_texts.dummy", "unit": "texts", "better": "higher",
                               "source": "program_counter", "layer": "front end",
                               "moves": "audio_s_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("dummy-cell", bench_dir=str(root / "ttsbench"), root=str(root))
    assert cell.config["name"] == "dummy-config"
    assert cell.kind.__file__ == str(root / "ttsbench/traffic/dummy_kind.py")
    assert cell.spec["params"]["texts_per_call"] == 32
    assert [m["name"] for m in cell.per_layer] == ["dummy_texts.dummy"]
    assert cell.reader("dummy_texts.dummy")({"texts": 7}) == 7
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
