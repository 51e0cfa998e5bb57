"""The output check's control, on the card: the plain reference computed with
TF32 products (the step below the configurations' float32 with TF32 off)
put in the program's place, at each cell's own size and on three seeds, has
to come out not correct. Skips without a card.

    python -m pytest benchmark/test_mtsbench_control.py -m cuda
"""
import os

import pytest

from mtsbench import harness, spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 33 + 303])
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_is_not_correct(workload, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist only there")
    cell = spec.load_cell(workload, ROOT)
    r = harness.run_cell(cell, seed, 1.0, False, "cuda", control=True)
    assert not r["correct"], r["checks"]
