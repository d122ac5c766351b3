"""The evaluate stage's device work on the card: the grafted ``videomae_base`` forward
and the batched few-shot step. Marked ``cuda``: every test skips where there is no CUDA
device. On a machine with one (and nvcc), from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_cuda.py

(``--noconftest``: the tests' conftest imports JAX, which the GPU machine need not
have; this file imports none.)
"""
import copy

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import init_params, variables_to_numpy
from tpuhar_torch.entry import build_fusion_task, classify_config, vit_config
from tpuhar_torch.eval import fewshot_parallel as pf
from tpuhar_torch.models import convert
from tpuhar_torch.models.crossmodal import FusionClassifier
from tpuhar_torch.models.video import VIT_CONFIGS
from tpuhar_torch.ops.flash_lean import flash_lean

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def test_grafted_videomae_base_forward_equals_direct_load(cuda, tmp_path):
    """``videomae_base`` exported, saved as ``.pt``, grafted by ``build_fusion_task``
    through ``model.video_weights_path``: the grafted ViT leaves equal the tree's, and
    the eval forward (12 flash launches) equals the same model loaded directly from the
    tree, bit for bit."""
    cfg = vit_config()
    depth, _, heads = VIT_CONFIGS[cfg.model.video_backbone]
    vit = init_params(cfg, torch.Generator().manual_seed(0))["params"]["video_encoder"]["vit"]
    convert.save_state_dict(convert.export_videomae_state_dict(vit, depth, heads), tmp_path / "videomae_base.pt")
    base = init_params(cfg, torch.Generator().manual_seed(1), FusionClassifier)
    direct_tree = copy.deepcopy(base)
    direct_tree["params"]["video_encoder"]["vit"] = vit
    graft_cfg = copy.deepcopy(cfg)
    graft_cfg.model.video_pretrained, graft_cfg.model.video_weights_path = True, str(tmp_path / "videomae_base.pt")
    grafted = build_fusion_task(graft_cfg, device=cuda, params=base, steps_per_epoch=1)
    got_vit = dict(_leaves(variables_to_numpy(grafted.model)["params"]["video_encoder"]["vit"]))
    for name, leaf in _leaves(vit):
        np.testing.assert_array_equal(got_vit[name], leaf, err_msg=name)
    direct = build_fusion_task(cfg, device=cuda, params=direct_tree, steps_per_epoch=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"imu": torch.randn((2, 6, 250), generator=gen, device=cuda),
             "video": torch.randint(0, 256, (2, 16, 224, 224, 3), generator=gen, device=cuda, dtype=torch.uint8),
             "label": torch.zeros(2, dtype=torch.long, device=cuda), "n_valid": 2}
    flash_lean.launches = 0
    got = grafted.eval_step(grafted.state, batch)
    assert flash_lean.launches == depth
    want = direct.eval_step(direct.state, batch)
    for key in ("logits", "embeddings", "preds"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["linear_probe", "finetune"])
def test_batched_fewshot_step_matches_sequential_steps(cuda, mode, dtype):
    """One train step of ``classify_config``'s IMU classifier for R = 3 runs stacked,
    against each run's step alone (the same code, R = 1), dropout off: in f32 (TF32 off)
    the losses within 1e-5 relative and the parameters after the step within 1e-6 +
    1e-4·lr where the run's gradient is above 1e-3 of its largest element (AdamW's first
    step turns a near-zero gradient's rounding into a ±lr move), within 2·lr everywhere;
    in bf16 (batched products round otherwise) the losses within 1e-2 and the
    parameters within 2·lr. The linear probe's encoder does not move."""
    cfg = classify_config()
    cfg.model.compute_dtype = dtype
    cfg.model.imu_dropout = cfg.model.classifier_dropout = 0.0
    R, B = 3, 64
    trees = pf.init_run_trees(cfg, mode, None, R, torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(0)
    imu = torch.randn((R, B, 6, 250), generator=gen, device=cuda)
    label = torch.randint(0, cfg.model.num_classes, (R, B), generator=gen, device=cuda)
    stacked = pf.BatchedRuns(cfg, mode, trees, device=cuda, steps_per_epoch=1)
    before = {n: p.clone() for n, p in stacked.params.items()}
    grads, _, _ = pf.BatchedRuns(cfg, mode, trees, device=cuda, steps_per_epoch=1).gradients(imu, label)
    out = stacked.train_step(imu, label)
    lr = {"encoder": cfg.training.train_lr_encoder, "head": cfg.training.train_lr_head}
    for r in range(R):
        alone = pf.BatchedRuns(cfg, mode, trees[r:r + 1], device=cuda, steps_per_epoch=1)
        one = alone.train_step(imu[r:r + 1], label[r:r + 1])
        torch.testing.assert_close(out["loss"][r], one["loss"][0], rtol=1e-5 if dtype == "float32" else 1e-2, atol=0)
        for n, p in stacked.params.items():
            step_lr = lr["encoder" if n.startswith("imu_encoder.") else "head"]
            err = (p[r] - alone.params[n][0]).abs()
            if mode == "linear_probe" and n.startswith("imu_encoder."):
                assert torch.equal(p[r], before[n][r]) and torch.equal(alone.params[n][0], before[n][r]), n
                continue
            assert err.max().item() <= 2 * step_lr, (r, n)
            if dtype == "float32":
                g = grads[n][r].abs()
                sure = g > 1e-3 * max(v[r].abs().max().item() for v in grads.values())
                assert torch.all(err[sure] <= 1e-6 + 1e-4 * step_lr), (r, n)
