"""The fusion classifier's train steps with the ``tpu_cnn``, ``resnet18``,
``mobilenet_v2`` and ``tiny_cnn`` towers against the JAX package's, as
``tests/test_torch_tower_steps.py``'s docstring sets them out: its sizes, its batches and
its shares of parameters held to the tight bound, ResNet-18 and MobileNetV2 in float64 in
both packages. They sit in a file of their own because those two float64 steps are the
slowest tests of the port: under ``--dist loadfile`` this file and the rest of
``test_torch_tower_steps.py`` then run on two workers.
"""
import jax
import pytest
import torch
from test_torch_classify_steps import _config, check_classification_step
from test_torch_tower_steps import TIGHT_SHARES, _batches

torch.set_num_threads(2)

# backbone -> the side of its frames
TOWERS = {"tpu_cnn": 64, "resnet18": 64, "mobilenet_v2": 64, "tiny_cnn": 32}
# the towers whose f32 gradients cannot be held to each other (the other file's
# docstring): their steps run in float64 in both packages
FLOAT64_STEPS = ("resnet18", "mobilenet_v2")


@pytest.mark.parametrize("backbone", list(TOWERS))
def test_fusion_step_with_tower_matches_jax(backbone):
    cfg = _config("layer")
    cfg.model.video_backbone = backbone
    cfg.data.video_resize = (TOWERS[backbone],) * 2
    args = ("fusion", "finetune", cfg, _batches(TOWERS[backbone]), TIGHT_SHARES[backbone], True)
    if backbone in FLOAT64_STEPS:
        cfg.model.compute_dtype = "float64"
        with jax.enable_x64(True):
            check_classification_step(*args)
    else:
        check_classification_step(*args)
