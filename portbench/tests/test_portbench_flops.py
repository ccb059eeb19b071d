"""``portbench/flops.py``'s closed forms against the port's bench convention
counted by ``torch.utils.flop_counter`` over one step of the reference."""


import pytest
import torch

from portbench import flops, inputs
from portbench.reference.train import ReferenceGAN
from portbench.spec import Spec
from portbench.tests import flop_rules, tiny

# The port's bench (``blurred_gan_tpu_torch.bench``): FlopCounterMode over a
# float32 step of the plain path at b2, scaled to b32.
BENCH_CELEBA128_B32 = 126_521_505_792


def counted_step(cfg):
    w = inputs.weights(cfg, 0, "cpu")
    gan = ReferenceGAN(cfg, w, "cpu")
    b = cfg["batch_size"]
    reals = torch.randint(0, 256, (b, *cfg["image_shape"]), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    with flop_rules.counting() as counter:
        gan.step(reals, float(cfg["sigma0"]), 1)
    return flop_rules.by_op(counter)


@pytest.mark.parametrize("name", ["tiny", "tiny_mnist", "celeba128_dcgan", "mnist28_dcgan"])
def test_closed_form_equals_the_counted_step(name):
    torch.set_num_threads(4)
    cfg = {"tiny": tiny.TINY, "tiny_mnist": tiny.TINY_MNIST}.get(name) or Spec().config(name)
    cfg = dict(cfg, batch_size=2)
    counted = counted_step(cfg)
    assert sum(counted.values()) == flops.step_flops_dense(cfg)
    # The networks alone: every convolution and Dense, without the blur's
    # band products (the first matmul of a plane is batched, the second not).
    blur_bmm = counted["aten.bmm"]
    assert blur_bmm * 2 == flops.blur_dense(cfg)
    assert sum(counted.values()) - 2 * blur_bmm == flops.networks_per_step(cfg)


def test_celeba128_b32_is_the_bench_count():
    cfg = Spec().config("celeba128_dcgan")
    assert flops.step_flops_dense(cfg) == BENCH_CELEBA128_B32
    # The configuration's count takes the blur by its taps at σ₀ = 5: 31 taps.
    assert flops.step_flops(cfg, 5.0) == flops.networks_per_step(cfg) + 672 * 2 * 31 * 128 * 128 * 2


def test_blur_work_follows_the_policy():
    cfg = Spec().config("mnist28_dcgan")
    # σ = 0.05 is floored to the policy's 3 taps.
    assert flops.blur_taps(cfg, 0.05) == 7 * 32 * 2 * 3 * 28 * 28 * 2
    assert flops.blur_bytes(cfg) == 7 * 32 * 28 * 28 * 8
