"""``chip_smoke.py``'s phase selector, on the CPU (the script itself needs a card): the
phases ``--phase`` runs, and the tables it reads to do so."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tpuhar_torch.entry import launch_counters  # noqa: E402

ALL = set(range(1, chip_smoke.LAST_PHASE + 1))


@pytest.mark.parametrize("argv,want", [
    ([], ALL),
    (["--phase", "30"], {1, 2, 30}),
    (["--phase", "23"], {1, 2, 21, 22, 23}),
    (["--phase", "10,26"], {1, 2, 4, 6, 8, 10, 24, 26}),
    (["--phase", "3,12"], {1, 2, 3, 12}),
])
def test_selected_phases(argv, want):
    assert chip_smoke.selected_phases(argv) == want


@pytest.mark.parametrize("argv", [["--phase", "31"], ["--phase", "0"], ["--phase", ","], ["--phase", "x"]])
def test_selected_phases_rejects(argv):
    with pytest.raises(SystemExit):
        chip_smoke.selected_phases(argv)


def test_every_kernel_has_an_entry_and_a_phase_that_drives_it():
    """Each counted wrapper has its ``KERNELS`` entry, which the full run holds to a
    launch by some phase's main path, and ``PHASE_NEEDS`` names phases that exist, each
    reading only earlier ones."""
    assert set(chip_smoke.KERNELS) == set(launch_counters())
    assert set(chip_smoke.PHASE_NEEDS) | set().union(*chip_smoke.PHASE_NEEDS.values()) <= ALL
    assert all(needs < {p} | set(range(1, p)) for p, needs in chip_smoke.PHASE_NEEDS.items())
