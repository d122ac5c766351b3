"""A run driven to its end on the CPU (past the look for a card) at tiny sizes, in f32:
sound it is correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault the cell can have."""
import json

import pytest

from harbench import run
from harbench.tests import tiny

SERVING = ["tpu_cnn.serve_b256", "videomae_base.serve_b256", "videomae_base.serve_b8"]


def _execute(cell, fault=None, traced=False):
    name = cell.split(".")[0]
    cfg = tiny.config(name)
    cfg["dtype"] = "float32"
    for st in cfg["stages"].values():
        st.setdefault("model", {})["compute_dtype"] = "float32"
    return run.execute(cell, 2**31 + 11, 0.3, traced, device="cpu", cfg=cfg, workload=tiny.workload(cell), fault=fault)


@pytest.mark.parametrize("cell", SERVING + ["videomae_base.pretrain_b16"])
def test_a_sound_run_is_correct(cell):
    r = _execute(cell)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check" and r["attempted"] > 0 and r["failed"] == 0
    json.dumps(r)


@pytest.mark.parametrize("cell", SERVING)
def test_an_altered_answer_is_not_correct(cell):
    assert not _execute(cell, "alter")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_train_step_is_not_correct(fault):
    r = _execute("videomae_base.pretrain_b16", fault)
    assert not r["correct"], r["check"]


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read():
    r = _execute("tpu_cnn.serve_b256", traced=True)
    assert set(r["metrics"]) <= {"device_idle_pct.serve", "mfu.serve", "conv3x3_roofline.serve"}
    assert "window_s" in r["device"] and "breakdown" in r


def test_without_a_card_the_command_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "tpu_cnn.serve_b256", "--seed", "3", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
