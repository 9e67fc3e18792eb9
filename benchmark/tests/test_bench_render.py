"""The traffic generator's frozen renderer."""

import numpy as np

from benchmark.harness import render


def test_a_seed_gives_one_pool_whatever_the_workers():
    one = render.render_pool(2**31 + 7, 4, 7, (96, 72), workers=1)
    two = render.render_pool(2**31 + 7, 4, 7, (96, 72), workers=2)
    for key in one:
        np.testing.assert_array_equal(one[key], two[key])
    other = render.render_pool(2**31 + 8, 4, 7, (96, 72), workers=1)
    assert not np.array_equal(one["images"], other["images"])


def test_the_copy_renders_as_the_port_renders():
    from dream_tpu_torch.data import synthetic

    for n_kp, out_of_frame in ((7, False), (17, True)):
        a = render.render_random_scene(np.random.RandomState(5), (96, 72), n_kp, out_of_frame)
        b = synthetic.render_random_scene(np.random.RandomState(5), (96, 72), n_kp, out_of_frame)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
