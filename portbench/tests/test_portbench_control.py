"""The control on the card, at each cell's own sizes: TF32 matmuls and the
plain inverse in float32 in the spline kernel's place must come out not
correct on three seeds, where the program itself comes out correct. Runs
on the chip only (``cuda`` marker): one job a seed."""

import pytest
import torch

from harness import cells

CELLS = [w['name'] for w in cells.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from tools.readings import readings
    sound = readings(workload, 9001)
    assert sound['correct'], sound
    for seed in (9101, 9102, 9103):
        control = readings(workload, seed, control='tf32')
        print('CONTROL', control)
        assert not control['correct'], control
