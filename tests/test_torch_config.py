"""The port's own ``Config`` (``tpuhar_torch/config.py``) against the JAX package's:
the same sections, fields and defaults, before and after an override per section, and
a file saved by one loads in the other."""
import pytest

from tpuhar.config import Config as JaxConfig
from tpuhar_torch.config import Config

SECTIONS = ("paths", "data", "model", "training", "eval", "ood")
OVERRIDES = {
    "paths": ("base_output", "/tmp/elsewhere"),
    "data": ("video_resize", "[112, 112]"),
    "model": ("use_flash_attention", "true"),
    "training": ("pretrain_epochs", "3"),
    "eval": ("few_shot_samples", "[5, 10]"),
    "ood": ("energy_temperature", "2.5"),
}


@pytest.mark.parametrize("section", SECTIONS)
def test_defaults_match_jax(section):
    assert Config().to_dict()[section] == JaxConfig().to_dict()[section]


@pytest.mark.parametrize("section", SECTIONS)
def test_override_matches_jax(section):
    key, value = OVERRIDES[section]
    ours, theirs = Config(), JaxConfig()
    ours.override(f"{section}.{key}", value)
    theirs.override(f"{section}.{key}", value)
    assert ours.to_dict()[section] == theirs.to_dict()[section]
    assert ours.to_dict()[section] != Config().to_dict()[section]


def test_saved_config_loads_in_both(tmp_path):
    cfg = JaxConfig()
    cfg.model.video_backbone = "videomae_small"
    cfg.data.video_resize = (160, 160)
    cfg.save(tmp_path / "cfg.json")
    assert Config.load(tmp_path / "cfg.json").to_dict() == JaxConfig.load(tmp_path / "cfg.json").to_dict()
