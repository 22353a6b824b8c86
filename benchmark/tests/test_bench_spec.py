"""BENCHMARK.json against its contract's form, and every name it uses found
as a file."""

from __future__ import annotations

import re

import pytest

from benchmark.harness import kinds, spec, traffic

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert 1 <= len(bench["workloads"]) <= 24 and 1 <= len(bench["configs"]) <= 24


def test_names_and_units_use_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]] + [w["config"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.fullmatch(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]] + [
        m["layer"] for m in bench["per_layer"]
    ]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique(bench):
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names)), group
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_workloads_name_cells(bench, group):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench[group]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_per_layer_metrics_are_reported_where_what_they_move_is(bench):
    for m in bench["per_layer"]:
        moves = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert cell in moves.get("workloads", [cell]), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric(bench):
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert c.per_layer, w["name"]


def test_cells_configs_mixes_and_readers_are_found_by_name(bench):
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c.config["name"] == w["config"]
        assert callable(kinds.find(c.traffic["kind"]).run_unit)
        assert w["chips"] in (1, 4)
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert c["source"].startswith("https://")
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        traffic.load("no-such-mix")
    with pytest.raises(FileNotFoundError):
        kinds.find("no-such-kind")


def test_configs_hold_every_encoder_field_of_the_program():
    import dataclasses

    from transplat_tpu_torch.config import dtu_config, re10k_config

    bench = spec.load_spec()
    for conf, program in (("re10k", re10k_config()), ("dtu-nctx3", dtu_config(3))):
        entry = next(c for c in bench["configs"] if c["name"] == conf)
        c = spec.cell(bench, next(w["name"] for w in bench["workloads"] if w["config"] == conf))
        from transplat_tpu_torch.model.encoder import EncoderCfg

        built = spec.build_dataclass(EncoderCfg, c.config["encoder"])
        assert dataclasses.asdict(built) == dataclasses.asdict(program.encoder), conf
        assert entry["reduced"] == []
