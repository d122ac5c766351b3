"""The plain reference against the port's own plain CPU path at tiny sizes, in f32: the
serving forwards of both towers, and three pretraining steps (dropout, SigLIP, the
backward, the clip and AdamW). Also the weight maker's tree against the port's."""
import pytest
import torch

from harbench import driver, run, traffic, weights
from harbench.reference.model import fusion_forward_blocks
from harbench.tests import tiny


def _f32(name, stage):
    c = run.staged(tiny.config(name), stage)
    c["dtype"] = "float32"
    c["model"]["compute_dtype"] = "float32"
    c["stages"][stage].setdefault("model", {})["compute_dtype"] = "float32"
    return c


@pytest.mark.parametrize("name", ["tpu_cnn", "videomae_base"])
def test_tree_has_the_port_s_leaves(name):
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.models.crossmodal import CrossModalModel
    from harbench.port import port_config

    stages = [("serve", weights.fusion_model, None)]
    if name == "videomae_base":
        stages.append(("pretrain", weights.crossmodal_model, CrossModalModel))
    for stage, leaves_of, model_cls in stages:
        cfg = run.staged(tiny.config(name), stage)
        leaves = leaves_of(cfg) if model_cls is None else leaves_of(cfg, cfg["stages"][stage])
        ours = weights.flatten(weights.as_tree(leaves, weights.make_flat(leaves, 1, "cpu")))
        theirs = weights.flatten(init_params(port_config(cfg, stage), torch.Generator().manual_seed(0), model_cls))
        assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in theirs.items()}


def test_weights_repeat_from_the_seed():
    cfg = run.staged(tiny.config("tpu_cnn"), "serve")
    leaves = weights.fusion_model(cfg)
    a, b = weights.make_flat(leaves, 5, "cpu"), weights.make_flat(leaves, 5, "cpu")
    assert (a == b).all() and not (a == weights.make_flat(leaves, 6, "cpu")).all()


@pytest.mark.parametrize("name", ["tpu_cnn", "videomae_base"])
def test_serving_forward_matches_the_port_in_f32(name):
    from tpuhar_torch import entry
    from harbench.port import port_config

    cfg = _f32(name, "serve")
    leaves = weights.fusion_model(cfg)
    flat = weights.make_flat(leaves, 3, "cpu")
    fn, _ = entry.build_forward(port_config(cfg, "serve"), 3, device="cpu", params=weights.as_tree(leaves, flat))
    g = traffic.generator(9, 1, device="cpu")
    raw, clip = traffic.imu_counts(cfg, 3, g), traffic.clips(cfg, 3, g)
    wire = traffic.patch_major(clip, cfg["tower"]["patch"]) if cfg["tower"]["kind"] == "cnn" else clip
    got = fn(raw, wire)
    gelu = "tanh" if cfg["model"].get("gelu_approximate") else "none"
    ref = fusion_forward_blocks(cfg, weights.as_tree(leaves, torch.from_numpy(flat)), raw, clip, gelu=gelu, block=2)
    for k in ("logits", "msp", "energy", "embeddings"):
        torch.testing.assert_close(got[k].float(), ref[k], rtol=2e-4, atol=2e-4)


def test_pretraining_steps_match_the_port_in_f32():
    from harbench.run import load_module, HERE
    from harbench import compare

    cfg = _f32("videomae_base", "pretrain")
    ctx = driver.Context(cfg, tiny.workload("videomae_base.pretrain_b16"), 7, torch.device("cpu"))
    drv = load_module(HERE / "drivers" / "pretrain.py", "harbench_test_pretrain").Driver(ctx)
    drv.setup()
    gaps = compare.training_gaps(drv.record, drv.reference())
    assert gaps["loss_rel"] < 1e-5 and gaps["grad1_rel"] < 1e-4 and gaps["change_rel"] < 1e-2, gaps


def test_fp8_control_is_further_from_f32_than_rounding():
    cfg = _f32("tpu_cnn", "serve")
    leaves = weights.fusion_model(cfg)
    tree = weights.as_tree(leaves, torch.from_numpy(weights.make_flat(leaves, 3, "cpu")))
    g = traffic.generator(9, 1, device="cpu")
    raw, clip = traffic.imu_counts(cfg, 2, g), traffic.clips(cfg, 2, g)
    a = fusion_forward_blocks(cfg, tree, raw, clip, gelu="tanh", block=2)
    b = fusion_forward_blocks(cfg, tree, raw, clip, gelu="tanh", block=2, precision="fp8")
    gap = float((a["logits"] - b["logits"]).abs().max() / a["logits"].abs().max())
    assert gap > 1e-2
