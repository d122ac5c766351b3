"""The yardstick's operation and byte counts against hand counts at the shapes of
PERF.md's kernel table."""
import pytest

from harbench import counts, port


def test_peaks_are_the_data_sheet_s():
    assert counts.PEAK_OPS_PER_S["bf16"] == 989e12 and counts.HBM_BYTES_PER_S == 3.35e12


def test_fused_conv_at_14x14x256_with_residual():
    ops = counts.conv3x3_ops(4096, 14, 256, 256)
    assert ops == 2 * 4096 * 196 * 9 * 256 * 256
    by = 4096 * 196 * 256 * 2 * 3 + 9 * 256 * 256 * 2 + 256 * 8
    assert counts.conv3x3_bytes(4096, 14, 256, 256, residual=True) == by
    assert counts.bound_s(ops, by) * 1e3 == pytest.approx(0.9576, abs=5e-5)  # bound by operations


def test_flash_forward_and_backward_bounds():
    assert counts.bound_s(counts.attention_fwd_ops(8, 12, 1568, 64), 0) * 1e3 == pytest.approx(0.0611, abs=5e-5)
    assert counts.bound_s(counts.attention_bwd_ops(16, 12, 1568, 64), 0) * 1e3 == pytest.approx(0.3055, abs=5e-5)
    v = port.config_file("videomae_base")
    a = counts.vit_attention(v, 256)
    assert a["launches"] == 12 and a["fwd_bound_s"] * 1e3 == pytest.approx(1.955, abs=1e-3)


def test_tpu_cnn_forward_convs():
    t = port.config_file("tpu_cnn")
    f = counts.conv3x3_forward(t, 256)
    assert f["launches"] == 4
    frames = 256 * 16
    assert f["ops"] == 2 * counts.conv3x3_ops(frames, 14, 256, 256) + 2 * counts.conv3x3_ops(frames, 7, 512, 512)


def test_model_flops_a_window():
    t, v = port.config_file("tpu_cnn"), port.config_file("videomae_base")
    tower = counts.video_tower_flops(t)["ops"]
    stem = 2 * 16 * 196 * 768 * 256
    convs = 16 * (4 * 196 * 2 * 9 * 256 * 256 / 2 + 49 * 2 * 9 * 256 * 512 + 4 * 49 * 2 * 9 * 512 * 512 / 2)
    assert tower == pytest.approx(stem + convs, rel=1e-12)
    assert tower / 1e9 == pytest.approx(17.9, abs=0.05)
    n, d = 1568, 768
    block = 4 * 2 * n * d * d + 4 * n * n * d + 2 * 2 * n * d * 4 * d
    vit = 2 * n * 1536 * d + 12 * block
    assert counts.video_tower_flops(v)["ops"] == pytest.approx(vit, rel=1e-12)
    assert 360e9 < counts.fusion_flops(v) < 370e9
    assert 17.9e9 < counts.fusion_flops(t) < 18.3e9
    assert counts.train_step_flops(v, 16) == pytest.approx(3 * 16 * counts.pretrain_forward_flops(v))


def test_mfu_refuses_an_empty_window():
    with pytest.raises(ValueError):
        counts.mfu_pct(1e12, 0.0)
