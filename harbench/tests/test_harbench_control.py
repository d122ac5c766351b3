"""The control on the card: the reference computed in fp8 in the program's place must
come out as not correct under each cell's limits. ``python3 -m harbench.control`` reads
it on more seeds beside the program's own readings. Each test decides inside itself
whether a card is there."""
import pytest

from harbench import compare, control, port, run

pytestmark = pytest.mark.cuda


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cells' own sizes")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["tpu_cnn.serve_b256", "videomae_base.serve_b256", "videomae_base.serve_b8",
                                  "videomae_base.pretrain_b16"])
def test_the_fp8_control_is_not_correct(cell):
    device = _card()
    read = control.fp8_training if "pretrain" in cell else control.fp8_serving
    limits = port.load_json(run.HERE / "workloads" / f"{cell}.json")["limits"]
    correct, table = compare.judge(read(cell, 2**31 + 78, device), limits)
    assert not correct, table
