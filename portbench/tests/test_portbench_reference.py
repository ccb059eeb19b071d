"""The plain reference against the port at small sizes on the CPU, and the
controls: the reference in a lower precision, or with a planted fault, put
in the program's place, reads above the limits."""

import json

import pytest
import torch

from portbench import control, inputs, port
from portbench.checks import Checks
from portbench.reference import blur as ref_blur
from portbench.reference import nets
from portbench.tests import tiny


@pytest.mark.parametrize("sigma", [0.05, 0.4, 2.5, 5.0, 23.5])
@pytest.mark.parametrize("size", [12, 28, 64])
def test_blur_is_the_ports(sigma, size):
    from blurred_gan_tpu_torch.ops.blur import blur_images

    x = torch.randn((2, 3, size, size), generator=torch.Generator().manual_seed(size))
    expected = blur_images(x, sigma, impl="torch")
    torch.testing.assert_close(ref_blur.blur(x, sigma), expected, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ref_blur.blur(x, sigma), blur_images(x, sigma), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("cfg", [tiny.TINY, tiny.TINY_MNIST], ids=["celeba_like", "mnist_like"])
@pytest.mark.parametrize("train", [False, True])
def test_networks_are_the_ports(cfg, train):
    w = inputs.weights(cfg, 11, "cpu")
    gan = port.gan(cfg)
    port.load(gan.generator, w["generator"])
    port.load(gan.discriminator, w["critic"])
    z = torch.rand((6, cfg["latent_size"]), generator=torch.Generator().manual_seed(1))
    stats = {}
    images = nets.generate(w["generator"], z, cfg["generator"], train=train, new_stats=stats)
    torch.testing.assert_close(images, gan.generate(z, train=train), rtol=1e-5, atol=1e-6)
    for k, v in stats.items():
        torch.testing.assert_close(v, gan.generator.state_dict()[k], rtol=1e-6, atol=1e-7)
    x = torch.rand((6, cfg["image_shape"][2], *cfg["image_shape"][:2])) * 2 - 1
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    torch.testing.assert_close(
        nets.critic(w["critic"], x, cfg["critic"], train=train, rng=g1),
        gan.discriminator.train(train)(x, generator=g2), rtol=1e-5, atol=1e-6)


def test_bf16_generator_stays_near_the_reference():
    cfg = dict(tiny.TINY, compute_dtype="bfloat16")
    w = inputs.weights(cfg, 12, "cpu")
    z = torch.rand((8, cfg["latent_size"]), generator=torch.Generator().manual_seed(2))
    expected = nets.generate(w["generator"], z, cfg["generator"], train=False)
    served = port.sampler(cfg, port.device("cpu"), w["generator"])(z)
    gap = ((served - expected).flatten(1).norm(dim=1) / expected.flatten(1).norm(dim=1)).max()
    assert 0 < gap < 0.05


@pytest.mark.parametrize("cell, precision, fault", [
    ("tiny.train", "fp8", None), ("tiny.train", "tf32", None),
    ("tiny.train", "float32", "half_batch"), ("tiny_mnist.train", "tf32", None),
    ("tiny.sample", "fp8", None)])
def test_controls_fail_the_limits(tmp_path, capsys, cell, precision, fault):
    root = tiny.make_root(tmp_path, {"tiny.train": dict(tiny.TRAIN, config="tiny"),
                                     "tiny_mnist.train": dict(tiny.TRAIN, config="tiny_mnist"),
                                     "tiny.sample": dict(tiny.SAMPLE, config="tiny")},
                          {"tiny": tiny.TINY, "tiny_mnist": tiny.TINY_MNIST})
    args = ["--workload", cell, "--seeds", "21,22,23", "--precision", precision]
    control.main(args + (["--fault", fault] if fault else []), root=root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    limits = (tiny.SAMPLE if cell.endswith("sample") else tiny.TRAIN)["limits"]
    assert len(lines) == 3
    for line in lines:
        checks = Checks(limits)
        for k, v in line["readings"].items():
            checks.add(k, v["value"])
        assert not checks.correct, line
