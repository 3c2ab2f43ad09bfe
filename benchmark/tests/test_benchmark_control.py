"""The control (the reference in the next precision down, TF32 products),
put in the program's place and judged by the cell's own comparison and
result line, comes out not correct: on the CPU through the TF32 emulation
at a size a test run holds, and on the card at the cell's own size
(``cuda``)."""

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny

SMALL = {"serve_open_loop": {"sample": 8, "ref_block": 4},
         "eval_passes": {"max_scenes": 12, "sample": 6},
         "train_resident": {"train_scenes": 600}}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0 + 2 ** -20])
    assert control.to_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


@pytest.mark.parametrize("cell", ["vlsat_mmgnet.serve.val", "vlsat_mmgnet.eval.val",
                                  "sgfn.train.val"])
def test_control_fails_the_check_on_the_cpu(cell):
    gen = control.core.load_cell(cell)["generator"]
    over = {"config": tiny.overrides(cell)["config"], "params": SMALL[gen]}  # depth 1
    line = control.control(cell, 7, torch.device("cpu"), over)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_the_check_on_the_card(cell, card):
    line = control.control(cell, 8, card)
    assert line["correct"] is False, line["checks"]
