"""Operation and byte counts of the yardstick."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import yardstick
from benchmark.reference.models import Net, parameter_spec


@pytest.mark.parametrize("arch,n_kp,res,layers", [
    ("vgg", 7, (64, 48), (3, 4, 23, 3)),
    ("resnet", 17, (72, 56), (3, 4, 23, 3)),
    ("resnet", 17, (64, 64), (1, 1, 1, 1)),
])
def test_forward_operations_equal_the_flop_counter(arch, n_kp, res, layers):
    params = {leaf.name: torch.zeros(leaf.shape) for leaf in parameter_spec(arch, n_kp, layers)}
    with FlopCounterMode(display=False) as counter:
        Net(arch, params, layers=layers)(torch.zeros(2, 3, res[1], res[0]), train=True)
    assert counter.get_total_flops() == 2 * yardstick.forward_flops(arch, n_kp, res, layers)


def test_byte_bounds_reproduce_the_kernel_table():
    assert round(yardstick.warp_bound_ms(32, 400, 400, 3), 4) == 0.0367
    assert round(yardstick.score_bound_ms(112, 100, 100), 5) == 0.00268


def test_published_sizes():
    assert yardstick.vgg_forward_flops(7, (400, 400)) == 141_782_400_000
    assert yardstick.train_step_flops("vgg", 7, (400, 400), 32) == 3 * 32 * 141_782_400_000
