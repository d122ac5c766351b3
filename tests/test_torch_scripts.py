"""The validation workflows of ``tpuhar_torch/scripts/`` against the JAX package's
``scripts/``, on the CPU.

- Arguments: every option of each port script has the JAX script's name, default,
  type and action, each parser read as ``tests/test_script_args.py`` loads the JAX
  scripts (``importlib`` on the file). The differences allowed are listed in
  ``ALLOWED``: the output paths (``outputs/X`` → ``outputs/torch/X``, ``docs/X`` →
  ``outputs/torch/docs/X``) and the device flag (the port runs on the card unless
  ``--cpu``, where two JAX scripts take ``--tpu`` and one takes no argument).
- ``build_config`` of ``bench_accuracy`` and ``article_workflow``: the JAX scripts'
  config field by field for the same argv.
- One module-scoped fixture, ``bench_accuracy --quick`` run end to end on the CPU: 3
  classes of the hard fixture, 4 frames of 32², the ``tpu_cnn`` tower, one epoch,
  held-out class 0; beside its ``FusionClassifier`` checkpoint of that class
  (``last.pt``) a JAX checkpoint (``last.msgpack``) of the same variables, carried across
  by the bridge. On it ``validate_int8_ood`` and ``rescore_ood_hard`` give the JAX
  scripts' per-class rows: every key equal, every AUROC within one discordant ID/OOD pair
  (``1 / (n_id · n_ood)``) and every FPR, TPR or accuracy within one window of its split
  (``1 / n``), both plus the 5e-5 of the 4-decimal rounding: the two packages' logits
  differ by f32 rounding, which can swap two scores that lie closer than that. The
  temperature is held within 1% and the ECEs within 2e-3: the temperature is the argmin
  of an NLL that is flat near it (logits 1e-6 apart moved it from 4.229 to 4.237).
- ``article_workflow`` end to end on the CPU, at sizes cut below ``--quick``'s with its
  own arguments (2 classes, one epoch of each stage, one few-shot cell of 2 runs; the
  pool's 6 sequences a split give 66 windows, one batch of 64) and clips written at 32²:
  ``--quick`` itself is what ``chip_smoke.py`` runs.
- ``graft_weights --dry-run`` accepts a good checkpoint and rejects a truncated one, as
  ``tests/test_graft_dryrun.py`` holds the JAX script.
"""
import argparse
import copy
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import flax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("validate_int8_ood", "rescore_ood_hard", "bench_accuracy", "article_workflow", "validate_pretraining",
           "graft_weights")
# (script, option): (JAX default, port default); "absent" where one side has no such option
ALLOWED = {
    ("validate_int8_ood", "--root"): ("outputs/bench_accuracy", "outputs/torch/bench_accuracy"),
    ("validate_int8_ood", "--out"): (
        "outputs/bench_accuracy/int8_ood_parity.json", "outputs/torch/bench_accuracy/int8_ood_parity.json"
    ),
    ("validate_int8_ood", "--tpu"): (False, "absent"),
    ("validate_int8_ood", "--cpu"): ("absent", False),
    ("rescore_ood_hard", "--root"): ("outputs/bench_accuracy_hard", "outputs/torch/bench_accuracy_hard"),
    ("rescore_ood_hard", "--out"): ("docs/ood_rescore_hard.json", "outputs/torch/docs/ood_rescore_hard.json"),
    ("rescore_ood_hard", "--tpu"): (False, "absent"),
    ("rescore_ood_hard", "--cpu"): ("absent", False),
    ("bench_accuracy", "--out"): ("outputs/bench_accuracy", "outputs/torch/bench_accuracy"),
    ("article_workflow", "--out"): ("docs/article_hard", "outputs/torch/docs/article_hard"),
    ("article_workflow", "--workdir"): ("outputs/article_hard", "outputs/torch/article_hard"),
    ("validate_pretraining", "--cpu"): ("absent", False),
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _options(parse, monkeypatch):
    """``{option: (dest, default, type, action class, required, nargs)}`` of the parser
    that ``parse()`` builds, read where it parses (so a parser built inside ``main``,
    as the JAX ``graft_weights`` builds it, is read too)."""
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        parse()
    except _Parsed:
        pass
    monkeypatch.undo()
    if "parser" not in seen:  # a script without arguments
        return {}
    out = {}
    for a in seen["parser"]._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        spec = (a.dest, a.default, a.type, type(a).__name__, a.required, a.nargs)
        for opt in a.option_strings or [a.dest]:
            out[opt] = spec
    return out


@pytest.mark.parametrize("name", SCRIPTS)
def test_arguments_match_the_jax_script(name, monkeypatch):
    jax_mod = _load(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    port_mod = importlib.import_module(f"tpuhar_torch.scripts.{name}")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    if "argparse" in (ROOT / "scripts" / f"{name}.py").read_text():
        want = _options(getattr(jax_mod, "parse_args", None) or jax_mod.main, monkeypatch)
    else:  # validate_pretraining takes no argument
        want = {}
    got = _options(port_mod.parse_args, monkeypatch)
    assert want or name == "validate_pretraining"
    for opt in sorted(set(want) | set(got)):
        if (name, opt) in ALLOWED:
            jax_default, port_default = ALLOWED[name, opt]
            assert (want[opt][1] if opt in want else "absent") == jax_default, opt
            assert (got[opt][1] if opt in got else "absent") == port_default, opt
            continue
        assert opt in want and opt in got, opt
        assert got[opt] == want[opt], opt


def _jax_args(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    return mod.parse_args()


def _fields(cfg):
    return {f"{section}.{k}": str(v) for section, values in cfg.to_dict().items() for k, v in values.items()}


def test_bench_accuracy_build_config_matches_jax(monkeypatch, tmp_path):
    from tpuhar_torch.scripts import bench_accuracy as port

    jax_mod = _load("jax_bench_accuracy_cfg", ROOT / "scripts" / "bench_accuracy.py")
    argv = ["--quick", "--loo-classes", "0,2", "--set", "training.seed=9", "--set", "model.head_norm=layer"]
    want = jax_mod.build_config(
        _jax_args(jax_mod, argv, monkeypatch), tmp_path / "fix", tmp_path / "out", "tpu_cnn", tmp_path / "pre"
    )
    args = port.parse_args(argv)
    got = port.build_config(args, tmp_path / "fix", tmp_path / "out", "tpu_cnn", tmp_path / "pre")
    assert _fields(got) == _fields(want)


def test_article_build_config_matches_jax(monkeypatch, tmp_path):
    """The config field by field, and the hard fixture asked of each package's
    generator with the same arguments (recorded, not written: the clips take seconds)."""
    import tpuhar.data.synthetic as jax_synthetic
    import tpuhar_torch.data.synthetic as port_synthetic
    from tpuhar_torch.scripts import article_workflow as port

    calls = []
    for mod in (jax_synthetic, port_synthetic):
        monkeypatch.setattr(mod, "generate_synthetic_dataset", lambda root, **kw: calls.append((root, kw)))
    jax_mod = _load("jax_article_cfg", ROOT / "scripts" / "article_workflow.py")
    argv = ["--infonce", "--coupling-strength", "3", "--classes", "2", "--samples", "1", "--backbone", "tiny_cnn",
            "--resize", "32", "--frames", "2", "--few-shot-samples", "1,3", "--no-coupling"]
    want = jax_mod.build_config(_jax_args(jax_mod, argv, monkeypatch), tmp_path / "jax")
    got = port.build_config(port.parse_args(argv), tmp_path / "port")
    strip = lambda f: {k: v.replace(str(tmp_path / "jax"), "W").replace(str(tmp_path / "port"), "W") for k, v in f.items()}  # noqa: E731
    assert strip(_fields(got)) == strip(_fields(want))
    (jax_root, jax_kw), (port_root, port_kw) = calls
    assert (jax_root, port_root) == (tmp_path / "jax" / "data", tmp_path / "port" / "data")
    assert port_kw == jax_kw and port_kw["cross_modal_coupling"] is False and port_kw["coupling_strength"] == 3.0


# ---------------------------------------------------------------------------------
# the leave-one-out fixture
# ---------------------------------------------------------------------------------
LOO = 0
BATCH = 8


@flax.struct.dataclass
class _JaxState:
    """What the JAX package's checkpoints hold of a ``TrainState``: its step, variables
    and optimizer state (none here: the scripts read the model only)."""

    step: int
    params: dict
    batch_stats: dict
    opt_state: dict


def _small_videos(monkeypatch):
    """Write the synthetic generator's clips at 32² (the workflows read them at 32²
    anyway): at 64² writing and decoding them took 24 of the ``article_workflow`` test's
    30 s."""
    import tpuhar_torch.data.synthetic as port_synthetic

    generate = port_synthetic.generate_synthetic_dataset
    monkeypatch.setattr(
        port_synthetic, "generate_synthetic_dataset", lambda *a, **kw: generate(*a, **{**kw, "video_size": (32, 32)})
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``bench_accuracy --quick`` on the CPU (the ``tpu_cnn`` tower, 3 classes of the hard
    fixture written at 32², 4 frames of 32², one epoch, held-out class ``LOO``) and its
    results; beside
    the port's ``ood_loo_{LOO}/last.pt`` the JAX package's ``last.msgpack`` of the same
    variables, carried across by the bridge."""
    from tpuhar.train import checkpoint as jckpt
    from tpuhar_torch.config import Config
    from tpuhar_torch.scripts import bench_accuracy
    from tpuhar_torch.scripts._common import restore_fusion_variables

    root = tmp_path_factory.mktemp("bench_accuracy")
    with pytest.MonkeyPatch.context() as mp:
        _small_videos(mp)
        results = bench_accuracy.main([
            "--quick", "--cpu", "--backbones", "tpu_cnn", "--classes", "3", "--samples", "2", "--epochs", "1",
            "--batch", str(BATCH), "--loo-classes", str(LOO), "--out", str(root),
        ])
    loo = root / "tpu_cnn" / "checkpoints" / f"ood_loo_{LOO}"
    cfg = Config.load(root / "tpu_cnn" / "checkpoints" / "config.json")
    cfg.model.num_classes = 2
    variables = restore_fusion_variables(cfg, loo / "last")
    jckpt.save_checkpoint(loo / "last", _JaxState(0, variables["params"], variables["batch_stats"], {}))
    return root, results, variables


def _split_sizes(root, c):
    import pandas as pd

    test = pd.read_csv(root / "preprocessed" / "test_metadata.csv")
    return int((test["label"] != c).sum()), int((test["label"] == c).sum())


def _close(key, got, want, root, c):
    n_id, n_ood = _split_sizes(root, c)
    if "auroc" in key:
        tol = 1.0 / (n_id * n_ood)
    elif "id_acc" in key:
        tol = 100.0 / n_id
    elif "temperature" in key:  # the argmin of a flat NLL: f32 rounding moves it
        tol = 1e-2 * abs(want)
    elif "ece" in key:
        tol = 2e-3
    else:  # FPRs and TPRs over the ID (or OOD) windows
        tol = 1.0 / min(n_id, n_ood)
    assert math.isfinite(got) and abs(got - want) <= tol + 5e-5, (c, key, got, want)


def _compare_rows(got, want, root, skip=()):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        c = w["held_out_class"]
        assert set(g) == set(w), set(g) ^ set(w)
        for key, value in w.items():
            if key in skip:
                continue
            if isinstance(value, dict):
                assert set(g[key]) == set(value)
                for k, v in value.items():
                    _close(f"{key}.{k}", g[key][k], v, root, c)
            elif isinstance(value, str) or key == "held_out_class":
                assert g[key] == value, key
            else:
                _close(key, g[key], value, root, c)


def _run_jax(name, argv, variables, monkeypatch):
    """The JAX script's ``main`` on ``argv``. Its template for the checkpoint's restore
    (``build_fusion_task``: an eager flax init of the model, 24 s a class on a CPU) is
    handed the tree the checkpoint holds instead: the restore takes only its structure,
    so every number the script writes comes from the checkpoint as before."""
    import types

    import tpuhar.train.factory as jax_factory

    state = _JaxState(0, variables["params"], variables["batch_stats"], {})
    monkeypatch.setattr(jax_factory, "build_fusion_task", lambda *a, **kw: types.SimpleNamespace(state=state))
    mod = _load(f"jax_run_{name}", ROOT / "scripts" / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


def test_bench_accuracy_writes_what_the_scorers_read(trained):
    root, results, _ = trained
    (r,) = results
    assert r["backbone"] == "tpu_cnn" and r["params_m"] > 0 and len(r["curve"]["train_loss"]) == 1
    for key in ("test_balanced_accuracy", "auroc_msp", "auroc_energy", "auroc_mahalanobis", "fpr95_msp"):
        assert math.isfinite(r[key]), key
    assert json.loads((root / "results.json").read_text()) == results
    ck = root / "tpu_cnn" / "checkpoints"
    for name in ("config.json", "data_fingerprint.json", "fusion_full/best_model.pt", f"ood_loo_{LOO}/last.pt",
                 f"ood_loo_{LOO}/training_history.json"):
        assert (ck / name).exists(), name


def test_validate_int8_ood_matches_jax(trained, tmp_path, monkeypatch):
    from tpuhar_torch.scripts import validate_int8_ood as port

    root, _, variables = trained
    common = ["--classes", str(LOO), "--root", str(root), "--batch", str(BATCH)]
    # the JAX run without its resident paths (half its 20 s of XLA compiles); the
    # port's resident paths are held to the JAX package's by tests/test_torch_serving_quant.py
    _run_jax("validate_int8_ood", common + ["--no-resident", "--out", str(tmp_path / "jax.json")], variables, monkeypatch)
    got = port.main(common + ["--cpu", "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    resident = {k for k in got[0] if k.startswith(("int8res", "int8pm", "pm_"))}
    assert len(resident) == 1 + 4 * 7  # pm_logit_maxdelta; per path 3 AUROCs, 3 FPRs, the accuracy
    _compare_rows([{k: v for k, v in got[0].items() if k not in resident}], want, root)
    assert got[0]["pm_logit_maxdelta"] == 0.0
    for key in resident:
        assert math.isfinite(got[0][key]), key


def test_rescore_ood_hard_matches_jax(trained, tmp_path, monkeypatch):
    from tpuhar_torch.scripts import rescore_ood_hard as port

    root, _, variables = trained
    common = ["--root", str(root), "--towers", "tpu_cnn", "--classes", str(LOO), "--batch", str(BATCH), "--knn-k", "3"]
    _run_jax("rescore_ood_hard", common + ["--out", str(tmp_path / "jax.json")], variables, monkeypatch)
    got = port.main(common + ["--cpu", "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(got) == set(want) == {"rows", "knn_k", "mean_by_tower"}
    assert got["knn_k"] == want["knn_k"] == 3
    _compare_rows(got["rows"], want["rows"], root, skip=("wall_s",))


def test_article_workflow_end_to_end(tmp_path, monkeypatch):
    from tpuhar_torch.scripts import article_workflow

    _small_videos(monkeypatch)
    # as on a host without matplotlib (the card's): the pipeline skips its plot
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    result = article_workflow.main([
        "--cpu", "--classes", "2", "--samples", "2", "--pretrain-samples", "3", "--pretrain-epochs", "1",
        "--epochs", "1", "--few-shot-samples", "1", "--runs", "2", "--backbone", "tiny_cnn", "--resize", "32",
        "--frames", "2", "--out", str(tmp_path / "out"), "--workdir", str(tmp_path / "work"),
    ])
    saved = json.loads((tmp_path / "out" / "article_workflow.json").read_text())
    assert saved["few_shot_cells"] == result["few_shot_cells"] and result["platform"] == "cpu"
    assert set(result["full_data"]) == {f"{m}/{t}" for m in ("linear_probe", "finetune") for t in ("pretrained", "scratch")}
    assert [(c["n_samples"], c["mode"]) for c in result["few_shot_cells"]] == [(1, "finetune"), (1, "linear_probe")]
    assert result["pretrain"]["epochs_ran"] == 1 and "val_retrieval" in result["pretrain"]
    for name in ("fewshot_pretrained_raw.csv", "fewshot_scratch_raw.csv", "summary.md"):
        assert (tmp_path / "out" / name).exists()


def _fake_resnet18(tmp_path, *, drop=None):
    tc = _load("tc_for_port_graft", ROOT / "tests" / "test_convert.py")
    sd = {"module." + k: v for k, v in tc._fake_resnet18_state_dict(np.random.default_rng(0)).items()}
    if drop:
        del sd["module." + drop]
    path = tmp_path / "r18.pt"
    torch.save(sd, path)
    return path, len(sd)


def test_graft_dry_run_accepts_a_good_checkpoint(tmp_path, capsys):
    from tpuhar_torch.scripts import graft_weights

    path, n = _fake_resnet18(tmp_path)
    graft_weights.main([str(path), "--backbone", "resnet18", "--dry-run", "--manifest", str(tmp_path / "report.json")])
    assert "DRY RUN OK" in capsys.readouterr().out
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["dry_run"] is True and report["source_tensors"] == n
    assert report["converted_video_encoder_tensors"] and report["converted_batch_stats_tensors"]
    first = next(iter(report["converted_video_encoder_tensors"].values()))
    assert set(first) == {"shape", "dtype", "sha256"}
    # the same digest as the JAX script's over the same converted tree
    jax_gw = _load("jax_graft_digest", ROOT / "scripts" / "graft_weights.py")
    from tpuhar.models.convert import convert_video_backbone, load_state_dict
    from tpuhar.config import Config

    cfg = Config()
    cfg.model.video_backbone = "resnet18"
    params, _ = convert_video_backbone(load_state_dict(str(path)), cfg)
    assert report["converted_video_encoder_tensors"] == jax_gw.tensor_digest(params)


def test_graft_dry_run_rejects_a_truncated_checkpoint(tmp_path):
    from tpuhar_torch.scripts import graft_weights

    path, _ = _fake_resnet18(tmp_path, drop="layer3.0.conv1.weight")
    with pytest.raises(KeyError) as e:
        graft_weights.main([str(path), "--backbone", "resnet18", "--dry-run"])
    assert "layer3.0.conv1.weight" in str(e.value)
