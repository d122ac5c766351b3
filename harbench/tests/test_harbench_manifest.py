"""BENCHMARK.json and the files it names, held to the benchmark's contract."""
import json

import pytest

from harbench import manifest, port


def test_benchmark_meets_the_contract():
    assert manifest.validate(port.ROOT.parent) == []


@pytest.mark.parametrize("bad,why", [
    ("a name", "space"), ("a,b", "comma"), ("a/b", "slash"), ("x" * 65, "too long"), (".a", "leading dot"),
])
def test_names_refuse_characters_outside_the_set(bad, why):
    assert not manifest.NAME.match(bad), why


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True), ("ms", True), ("windows/s", True),
                                     ("tokens per second", False), ("µs", False), ("x" * 17, False)])
def test_units(unit, ok):
    assert bool(manifest.UNIT.match(unit)) == ok


def _bench():
    return json.loads((port.ROOT.parent / "BENCHMARK.json").read_text())


def test_every_metric_lists_existing_cells_and_every_cell_reports_what_its_layer_metrics_move():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for m in b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_a_per_layer_metric_listing_a_cell_that_lacks_its_end_to_end_metric_is_refused(tmp_path):
    root = port.ROOT.parent
    b = _bench()
    b["per_layer"][0]["workloads"] = ["videomae_base.pretrain_b16"]  # moves fused_inf_per_s, which it lacks
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "harbench").symlink_to(root / "harbench")
    assert any("does not report" in e for e in manifest.validate(tmp_path))


def test_the_run_length_fits_a_full_check_of_24_cells():
    assert manifest.check_budget(_bench()["run_seconds"])
    assert not manifest.check_budget(52)


def test_configuration_files_hold_the_published_widths():
    v = port.config_file("videomae_base")
    s, t = v["source_config"], v["tower"]
    assert (t["depth"], t["d_model"], t["heads"], t["mlp"]) == (
        s["num_hidden_layers"], s["hidden_size"], s["num_attention_heads"], s["intermediate_size"])
    assert t["tubelet"] == [s["tubelet_size"], s["patch_size"], s["patch_size"]]
    for name in ("tpu_cnn", "videomae_base"):
        c = port.config_file(name)
        assert c["reduced"] == [] and len(c["source"]) <= 200 and c["assumed"]
