"""The check's control: the reference in bfloat16 in the program's place
fails the cell's limits, the reference in float32 passes them.  On the CPU
at a small size; at a cell's own size on a card (`-m cuda`)."""
import pytest
import torch

from featbench import check as C
from featbench import control
from featbench import harness
from featbench.testutil import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"), checked=2)


@pytest.mark.parametrize("cell", ["tiny.single", "tiny.sequence",
                                  "tiny_hs.single"])
def test_control_fails_and_reference_passes(root, cell):
    limits = harness.load_cell(cell, root).traffic["check"]["limits"]
    seed = 2 ** 31 + 3
    low = control.readings(cell, seed, torch.bfloat16, "cpu", root)
    ok, table = C.verdict(low, limits)
    assert not ok
    failing = {k for k, v in table.items() if not v["value"] <= v["limit"]}
    assert {"kp_mismatch", "desc_bytes_share"} <= failing
    if cell == "tiny.sequence":
        assert "match_mismatch_share" in failing
    ok, table = C.verdict(control.readings(cell, seed, None, "cpu", root),
                          limits)
    assert ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ref4k_bad256.photos", "kitti_bad256.vo"])
def test_control_fails_at_the_cells_size(cuda_device, cell):
    limits = harness.load_cell(cell).traffic["check"]["limits"]
    ok, _ = C.verdict(control.readings(cell, 2 ** 31 + 19, torch.bfloat16,
                                       cuda_device), limits)
    assert not ok
