"""The port on a CUDA card: the blur kernel and the train step against their
plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card. The file imports
no jax, so that on a machine with a card and no jax it runs without the
suite's conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: forward rtol 1e-5 / atol 1e-5 (float32 on both sides, another
summation order); gradients and grad-of-grad rtol 1e-4 / atol 1e-5, as the CPU
parity tests; a whole step rtol 1e-4 / atol 1e-4 on its losses.
"""

import pytest
import torch

from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.ops import blur_cuda
from blurred_gan_tpu_torch.ops.blur import blur_matrix
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_three_orders_match(x, t_h, t_w):
    """Forward, backward and the penalty's double backward: kernel vs plain."""
    p = x.shape[0]
    x.requires_grad_(True)
    got = blur_cuda.blur_planes(x, t_h, t_w)
    want = blur_cuda.blur_planes_reference(x, t_h, t_w)
    torch.testing.assert_close(got, want, **FWD)
    (g,) = torch.autograd.grad(torch.sum(got ** 2), x, create_graph=True)
    (gw,) = torch.autograd.grad(torch.sum(want ** 2), x, create_graph=True)
    torch.testing.assert_close(g, gw, **GRAD)
    (gg,) = torch.autograd.grad(torch.sum(torch.sqrt(torch.sum(g.reshape(p, -1) ** 2, 1))), x)
    (ggw,) = torch.autograd.grad(torch.sum(torch.sqrt(torch.sum(gw.reshape(p, -1) ** 2, 1))), x)
    torch.testing.assert_close(gg, ggw, **GRAD)
    return got


@pytest.mark.parametrize("sigma", [0.1, 2.0, 5.0, 100.0])
def test_kernel_sigma_sweep(cuda_device, sigma):
    # The 3-tap floor, σ = 2, the run's σ₀ and the clip to 128 taps: the band
    # ranges go from 4 k per tile to all 128.
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(192, 128, 128, device=cuda_device, generator=gen)
    t = blur_matrix(sigma, 128, device=cuda_device)
    assert_three_orders_match(x, t, t)


def test_kernel_zero_tile(cuda_device):
    # An all-zero row tile of T_h and column tile of T_w: those outputs are 0.
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    t = blur_matrix(5.0, 128, device=cuda_device)
    t[32:64, :] = 0
    t[:, 64:96] = 0
    got = assert_three_orders_match(torch.randn(8, 128, 128, device=cuda_device, generator=gen),
                                    t, t)
    assert torch.count_nonzero(got[:, 32:64]) == 0
    assert torch.count_nonzero(got[:, :, 64:96]) == 0


@pytest.mark.parametrize("p,h,w", [(3, 20, 12), (2, 8, 30), (4, 37, 5)])
def test_kernel_narrower_than_a_column_tile(cuda_device, p, h, w):
    # Fewer columns than a warp's tile, widths off the float4 path included.
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(p, h, w, device=cuda_device, generator=gen)
    assert_three_orders_match(x, blur_matrix(1.5, h, max(h, w), device=cuda_device),
                              blur_matrix(1.5, w, max(h, w), device=cuda_device))


def test_kernel_unaligned_planes(cuda_device):
    # A contiguous view at an offset of one float: the scalar-load path.
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(1 + 4 * 32 * 32, device=cuda_device, generator=gen)[1:].view(4, 32, 32)
    t = blur_matrix(2.0, 32, device=cuda_device)
    torch.testing.assert_close(blur_cuda.blur_planes_forward(x, t, t),
                               blur_cuda.blur_planes_reference(x, t, t), **FWD)


def test_occupancy_fills_the_card_in_one_wave(cuda_device):
    # 192 planes of 128² are 768 blocks of 32 rows: one wave needs 6 per SM.
    blocks, smem = blur_cuda.occupancy(128)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert smem < 48 * 1024
    assert blocks * sms >= 192 * 128 // blur_cuda.ROW_TILE, (blocks, sms)


@pytest.mark.parametrize("p,h,w", [(6, 28, 28), (6, 64, 64), (192, 128, 128),
                                   (3, 256, 256), (2, 16, 32)])
def test_kernel_matches_plain(cuda_device, p, h, w):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(p, h, w, device=cuda_device, generator=gen)
    before = blur_cuda.launch_count
    assert_three_orders_match(x, blur_matrix(2.0, h, max(h, w), device=cuda_device),
                              blur_matrix(2.0, w, max(h, w), device=cuda_device))
    # forward 1, backward 1; the double backward goes back through both the
    # transposed blur and the forward blur: 2.
    assert blur_cuda.launch_count - before == 4


def test_kernel_nonsymmetric(cuda_device):
    # Arbitrary T_h, T_w, as the transpose passes them; unit-scale products.
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(5, 40, 72, device=cuda_device, generator=gen)
    t_h = torch.randn(40, 40, device=cuda_device, generator=gen) / 40 ** 0.5
    t_w = torch.randn(72, 72, device=cuda_device, generator=gen) / 72 ** 0.5
    torch.testing.assert_close(blur_cuda.blur_planes(x, t_h, t_w),
                               blur_cuda.blur_planes_reference(x, t_h, t_w), **FWD)


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    x = torch.randn(2, 8, 8, device=cuda_device)
    t = torch.eye(8, device=cuda_device)
    with pytest.raises(TypeError):
        blur_cuda.blur_planes_forward(x.double(), t.double(), t.double())
    with pytest.raises(ValueError):
        blur_cuda.blur_planes_forward(x.transpose(1, 2), t, t)
    wide = blur_cuda.MAX_W + 1
    with pytest.raises(ValueError):
        blur_cuda.blur_planes_forward(torch.zeros(1, 1, wide, device=cuda_device),
                                      torch.eye(1, device=cuda_device),
                                      torch.eye(wide, device=cuda_device))


def test_step_kernel_matches_plain_blur(cuda_device):
    # One narrow step with the kernel and one with the plain blur, from the
    # same weights and the same draws.
    metrics = {}
    launches = {}
    reals = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8, device=cuda_device)
    for impl in ("cuda", "torch"):
        gan = GAN(DCGANGenerator(latent_size=8, init_features=32,
                                 blocks=((32, 1), (16, 2), (8, 2))),
                  DCGANDiscriminator(channels=(8, 16), in_channels=3, image_hw=(16, 16)),
                  latent_size=8, blur_impl=impl)
        hp = BlurredWGANGPHyperParameters(batch_size=4, global_batch_size=4)
        state = create_train_state(gan, hp, device=cuda_device, seed=0)
        before = blur_cuda.launch_count
        metrics[impl], _ = make_train_step(gan, hp, seed=0)(state, reals, 1.5)
        torch.cuda.synchronize()
        launches[impl] = blur_cuda.launch_count - before
    assert launches == {"cuda": 6, "torch": 0}
    for k, v in metrics["cuda"].items():
        torch.testing.assert_close(v, metrics["torch"][k], **STEP, msg=k)


def test_restore_on_the_card_is_exact_and_keeps_adams_step_on_the_cpu(cuda_device, tmp_path):
    # A checkpoint of a card's state restores into a fresh state bit for bit,
    # each tensor on the device a fresh optimizer gives it (Adam's step
    # counter on the CPU), and the next steps then agree.
    from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager

    def narrow():
        gan = GAN(DCGANGenerator(latent_size=8, init_features=32,
                                 blocks=((32, 1), (16, 2), (8, 2))),
                  DCGANDiscriminator(channels=(8, 16), in_channels=3, image_hw=(16, 16)),
                  latent_size=8)
        hp = BlurredWGANGPHyperParameters(batch_size=4, global_batch_size=4)
        return gan, hp, create_train_state(gan, hp, device=cuda_device, seed=0)

    reals = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8, device=cuda_device)
    gan, hp, live = narrow()
    step = make_train_step(gan, hp, seed=0)
    step(live, reals, 1.5)
    ckpt = CheckpointManager(str(tmp_path), keep_time_interval_hours=None)
    ckpt.save(live.n_img, live)
    gan2, _, restored = narrow()
    assert ckpt.restore_latest(restored) == ({}, 4)
    assert (restored.n_img, restored.n_batches) == (4, 1)
    for name in ("g_opt", "d_opt"):
        a = getattr(live, name).state_dict()["state"]
        b = getattr(restored, name).state_dict()["state"]
        for i in a:
            for k, v in a[i].items():
                assert v.device == b[i][k].device and torch.equal(v, b[i][k]), (name, i, k)
            assert b[i]["step"].device.type == "cpu"
    for m, m2 in ((live.generator, restored.generator),
                  (live.discriminator, restored.discriminator)):
        for (k, v), (_, v2) in zip(m.state_dict().items(), m2.state_dict().items()):
            assert v.device == v2.device and torch.equal(v, v2), k
    got = make_train_step(gan2, hp, seed=0)(restored, reals, 1.5)[0]
    want = step(live, reals, 1.5)[0]
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, **STEP, msg=k)
