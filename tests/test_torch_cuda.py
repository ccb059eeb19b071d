"""The port on a CUDA card: the blur kernel (σ mode, the main path, and T
mode) and the train step against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card. The file imports
no jax, so that on a machine with a card and no jax it runs without the
suite's conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: forward rtol 1e-5 / atol 1e-5 (float32 on both sides, another
summation order); gradients and grad-of-grad rtol 1e-4 / atol 1e-5, as the CPU
parity tests; a whole step rtol 1e-4 / atol 1e-4 on its losses; a whole
bfloat16 step rtol 1e-2 / atol 1e-3 (``chip_smoke.py``'s: float32 blur outputs
that differ in the last bits round to bfloat16 differently at a few elements).
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
BF16_STEP = dict(rtol=1e-2, atol=1e-3)

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


# ---------------------------------------------------------------------------
# σ mode: the kernel builds the band's taps from σ on the card
# ---------------------------------------------------------------------------

SIGMAS = (0.05, 0.3, 2.5, 5.0, 23.5, 100.0)


@pytest.mark.parametrize("planes", [1, 96, 192])
@pytest.mark.parametrize("h,w", [(28, 28), (64, 64), (128, 128), (256, 256), (16, 32),
                                 (36, 30)])
def test_sigma_mode_matches_plain(cuda_device, planes, h, w):
    # The main path's sizes and two non-square planes (36x30 off the float4
    # path), across σ; then the three orders at σ 2.5: one launch a call.
    from blurred_gan_tpu_torch.ops import blur

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(planes, h, w, device=cuda_device, generator=gen)
    s = torch.zeros((), device=cuda_device)
    for sigma in SIGMAS:
        s.fill_(sigma)
        torch.testing.assert_close(blur_cuda.blur_sigma_forward(x, s, max(h, w)),
                                   blur_cuda.blur_sigma_reference(x, s, max(h, w)), **FWD,
                                   msg=lambda m: f"sigma {sigma}: {m}")
    s.fill_(2.5)
    x.requires_grad_(True)
    before = blur_cuda.launch_count, blur_cuda.sigma_launch_count, blur.matrix_count
    got = three_orders(lambda v: blur_cuda.blur_sigma(v, s, max(h, w)), x)
    torch.cuda.synchronize()
    assert (blur_cuda.launch_count - before[0], blur_cuda.sigma_launch_count - before[1],
            blur.matrix_count - before[2]) == (4, 4, 0)
    want = three_orders(lambda v: blur_cuda.blur_sigma_reference(v, s, max(h, w)), x)
    for a, b, tol in zip(got, want, (FWD, GRAD, GRAD)):
        torch.testing.assert_close(a, b, **tol)


def three_orders(fn, x):
    """Forward, backward and the penalty's double backward of ``fn`` at x."""
    y = fn(x)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), x, create_graph=True)
    (gg,) = torch.autograd.grad(torch.sum(torch.sqrt(torch.sum(g.reshape(x.shape[0], -1) ** 2,
                                                               1))), x)
    return y.detach(), g.detach(), gg


@pytest.mark.parametrize("h,w", [(1, 1), (1, 6), (5, 1), (2, 2), (3, 3)])
def test_sigma_mode_tiny_planes(cuda_device, h, w):
    # Planes below the 3-tap floor (at 1x1 the policy gives one tap, half 0,
    # the identity), and a NaN σ, whose taps are NaN as the plain version's are.
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(5, h, w, device=cuda_device, generator=gen)
    s = torch.zeros((), device=cuda_device)
    for sigma in SIGMAS + (float("nan"),):
        s.fill_(sigma)
        torch.testing.assert_close(blur_cuda.blur_sigma_forward(x, s, max(h, w)),
                                   blur_cuda.blur_sigma_reference(x, s, max(h, w)), **FWD,
                                   equal_nan=True, msg=lambda m: f"sigma {sigma}: {m}")


def test_sigma_mode_unaligned_planes(cuda_device):
    # A contiguous view at an offset of one float: the copies without the
    # copy engine.
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(1 + 4 * 32 * 32, device=cuda_device, generator=gen)[1:].view(4, 32, 32)
    s = torch.tensor(2.0, device=cuda_device)
    torch.testing.assert_close(blur_cuda.blur_sigma_forward(x, s, 32),
                               blur_cuda.blur_sigma_reference(x, s, 32), **FWD)


def test_sigma_mode_graph_replays_a_new_sigma(cuda_device):
    # σ is read on the card: a graph captured once replays with each σ
    # written into its tensor, equal to an eager call bit for bit (the sums
    # run in a fixed order) and to the plain version.
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    for planes, res in ((96, 64), (192, 128)):
        x = torch.randn(planes, res, res, device=cuda_device, generator=gen)
        s = torch.tensor(5.0, device=cuda_device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            blur_cuda.blur_sigma_forward(x, s, res)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = blur_cuda.blur_sigma_forward(x, s, res)
        for sigma in (5.0, 0.05, 2.5, 23.5, 100.0, 5.0):
            s.fill_(sigma)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, blur_cuda.blur_sigma_forward(x, s, res)), sigma
            torch.testing.assert_close(out, blur_cuda.blur_sigma_reference(x, s, res), **FWD)


def test_step_launches_sigma_mode_and_builds_no_band_matrix(cuda_device):
    from blurred_gan_tpu_torch.ops import blur

    gan = narrow_gan()
    hp = BlurredWGANGPHyperParameters(batch_size=4, global_batch_size=4)
    state = create_train_state(gan, hp, device=cuda_device, seed=0)
    step = make_train_step(gan, hp, seed=0)
    reals = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8, device=cuda_device)
    for sigma in (1.5, torch.tensor(1.5, device=cuda_device)):
        before = blur_cuda.launch_count, blur_cuda.sigma_launch_count, blur.matrix_count
        step(state, reals, sigma)
        torch.cuda.synchronize()
        assert (blur_cuda.launch_count - before[0], blur_cuda.sigma_launch_count - before[1],
                blur.matrix_count - before[2]) == (6, 6, 0)


def test_sigma_that_requires_grad_takes_t_mode(cuda_device):
    # σ's gradient flows through the band matrices, as on the CPU.
    from blurred_gan_tpu_torch.ops import blur

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(2, 3, 32, 32, device=cuda_device, generator=gen)
    weights = torch.randn(x.shape, device=cuda_device, generator=gen)
    grads = {}
    for device in (cuda_device, torch.device("cpu")):
        s = torch.tensor(2.5, device=device, requires_grad=True)
        before = blur_cuda.sigma_launch_count, blur.matrix_count
        y = blur.blur_images(x.to(device), s)
        (grads[device.type],) = torch.autograd.grad(torch.sum(y * weights.to(device)), s)
        if device.type == "cuda":
            assert blur_cuda.sigma_launch_count == before[0]
            assert blur.matrix_count - before[1] == 2
    torch.testing.assert_close(grads["cuda"].cpu(), grads["cpu"], rtol=1e-4, atol=1e-6)


def test_sigma_mode_raises_instead_of_falling_back(cuda_device):
    x = torch.randn(2, 8, 8, device=cuda_device)
    with pytest.raises(TypeError):
        blur_cuda.blur_sigma_forward(x, torch.tensor(1.0, device=cuda_device,
                                                     dtype=torch.float64), 8)
    with pytest.raises(ValueError):
        blur_cuda.blur_sigma_forward(x, torch.tensor(1.0), 8)  # σ on the CPU
    with pytest.raises(ValueError):
        blur_cuda.blur_sigma_forward(x, torch.ones(2, device=cuda_device), 8)
    with pytest.raises(ValueError):
        blur_cuda.blur_sigma_forward(x.transpose(1, 2), torch.tensor(1.0, device=cuda_device), 8)
    with pytest.raises(ValueError):
        blur_cuda.blur_sigma_forward(x, torch.tensor(1.0, device=cuda_device), 4)


def narrow_gan(blur_impl="auto", compute_dtype=torch.float32, fast_gen=False):
    """The narrow 16x16x3 pair; ``compute_dtype`` and ``fast_gen`` as the
    entry point's ``--bf16`` and ``--fast_gen`` set them."""
    gen_kw = {"bn_dtype": compute_dtype, "output_f32": False} if fast_gen else {}
    return GAN(DCGANGenerator(latent_size=8, init_features=32, blocks=((32, 1), (16, 2), (8, 2)),
                              compute_dtype=compute_dtype, **gen_kw),
               DCGANDiscriminator(channels=(8, 16), in_channels=3, image_hw=(16, 16),
                                  compute_dtype=compute_dtype),
               latent_size=8, blur_impl=blur_impl)


@pytest.mark.parametrize("compute_dtype,fast_gen,tol", [
    (torch.float32, False, STEP), (torch.bfloat16, False, BF16_STEP),
    (torch.bfloat16, True, BF16_STEP)], ids=["float32", "bf16", "bf16+fast_gen"])
def test_step_kernel_matches_plain_blur(cuda_device, compute_dtype, fast_gen, tol, monkeypatch):
    # One narrow step with the kernel and one with the plain blur, from the
    # same weights and the same draws, under deterministic cuDNN (the bf16
    # generator's float32 products vary from run to run otherwise).
    metrics = {}
    launches = {}
    reals = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8, device=cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for impl in ("cuda", "torch"):
        gan = narrow_gan(impl, compute_dtype, fast_gen)
        hp = BlurredWGANGPHyperParameters(batch_size=4, global_batch_size=4)
        state = create_train_state(gan, hp, device=cuda_device, seed=0)
        before = blur_cuda.launch_count
        metrics[impl], fakes = make_train_step(gan, hp, seed=0)(state, reals, 1.5)
        torch.cuda.synchronize()
        launches[impl] = blur_cuda.launch_count - before
        assert fakes.dtype == (compute_dtype if fast_gen else torch.float32)
    assert launches == {"cuda": 6, "torch": 0}
    for k, v in metrics["cuda"].items():
        torch.testing.assert_close(v, metrics["torch"][k], **tol, msg=k)


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


# ---------------------------------------------------------------------------
# The chunked mode: the train step captured in a CUDA graph and replayed
# ---------------------------------------------------------------------------


def narrow_trainer(device, log_dir, gan=None, **kw):
    from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
    from blurred_gan_tpu_torch.sched.blur import BlurDecayController
    from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig

    gan = gan or narrow_gan()
    hp = BlurredWGANGPHyperParameters(batch_size=4, global_batch_size=4)
    if "adaptive_controller" not in kw:
        kw["blur_controller"] = BlurDecayController(640, max_value=1.5)
    return Trainer(gan, hp, synthetic_dataset((16, 16, 3), num_examples=64), device=device,
                   trainer_config=TrainerConfig(log_dir=str(log_dir), seed=0,
                                                image_summaries_interval_batches=0,
                                                sample_grid_every_n_examples=0,
                                                checkpoint_every_n_examples=0), **kw)


def test_chunked_replay_matches_fit(cuda_device, tmp_path):
    # 4 steps of fit against 2 chunks of 2 replayed steps, from the same
    # weights, data and draws (tests/test_fast.py's tolerance).
    a = narrow_trainer(cuda_device, tmp_path / "fit")
    a.fit(total_examples=10_000, max_steps=4)
    b = narrow_trainer(cuda_device, tmp_path / "chunked")
    b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=2)
    assert b.chunk_runner.graph is not None and b.chunk_runner.capture_seconds > 0
    assert a.state.n_batches == b.state.n_batches == 4
    for ha, hb in zip(a.history, b.history):
        assert hb["disc_loss"] == pytest.approx(ha["disc_loss"], rel=1e-3, abs=1e-4)
        assert hb["std"] == pytest.approx(ha["std"], rel=1e-6)
    for m, m2 in ((a.state.generator, b.state.generator),
                  (a.state.discriminator, b.state.discriminator)):
        for (k, v), v2 in zip(m.state_dict().items(), m2.state_dict().values()):
            torch.testing.assert_close(v2, v, rtol=5e-4, atol=5e-5, msg=k)


@pytest.mark.parametrize("fast_gen", [False, True], ids=["bf16", "bf16+fast_gen"])
def test_bf16_captured_step_replays_the_eager_step(cuda_device, tmp_path, fast_gen):
    # A bfloat16 step captured once and replayed twice against two eager
    # steps from the same weights, data and draws, with the chunked mode's
    # capturable Adam and deterministic cuDNN: the same bits.
    from blurred_gan_tpu_torch.train.state import set_capturable

    torch.backends.cudnn.deterministic = True
    try:
        a = narrow_trainer(cuda_device, tmp_path / "fit",
                           narrow_gan(compute_dtype=torch.bfloat16, fast_gen=fast_gen))
        step = a.step_fn

        def capturable_step(state, *args, **kwargs):
            set_capturable(state.g_opt, True)
            set_capturable(state.d_opt, True)
            return step(state, *args, **kwargs)

        a.step_fn = capturable_step
        a.fit(total_examples=10_000, max_steps=2)
        b = narrow_trainer(cuda_device, tmp_path / "chunked",
                           narrow_gan(compute_dtype=torch.bfloat16, fast_gen=fast_gen))
        b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert b.chunk_runner.graph is not None
    assert b.chunk_runner.fakes.dtype == (torch.bfloat16 if fast_gen else torch.float32)
    assert len(a.history) == len(b.history) == 2
    for ha, hb in zip(a.history, b.history):
        for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores",
                  "real_scores", "std"):
            assert hb[k] == ha[k], k


def test_replay_draws_follow_the_seed(cuda_device, tmp_path):
    # Two replays from the same state with different seeds draw different
    # latents; a replay draws what the eager step draws for the same seed.
    from blurred_gan_tpu_torch.train.fast import state_tensors
    from blurred_gan_tpu_torch.train.step import make_step_body

    tr = narrow_trainer(cuda_device, tmp_path)
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    runner = tr.chunk_runner
    with torch.no_grad():
        saved = [t.clone() for t in state_tensors(tr.state)]

    @torch.no_grad()
    def rewind():
        for t, v in zip(state_tensors(tr.state), saved):
            t.copy_(v)
        runner.row.zero_()
        runner.n_batches.fill_(2)

    fakes = {}
    for seed in (11, 12, 11):
        rewind()
        tr.state.rng.manual_seed(seed)
        runner.graph.replay()
        fakes.setdefault(seed, []).append(runner.fakes.clone())
    rewind()
    tr.state.rng.manual_seed(11)
    reals = runner.data.index_select(0, runner.idx[0])
    _, eager = make_step_body(tr.gan, tr.hparams)(tr.state, reals, 1.0)
    assert not torch.allclose(fakes[11][0], fakes[12][0])
    assert torch.equal(fakes[11][0], fakes[11][1])
    torch.testing.assert_close(eager, fakes[11][0], rtol=1e-5, atol=1e-6)


def test_stop_freeze_inside_the_graph(cuda_device, tmp_path):
    from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController

    ada = AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                 max_value=1.0, min_value=0.995)
    tr = narrow_trainer(cuda_device, tmp_path, adaptive_controller=ada)
    tr.fit_device_resident(total_examples=10_000, chunk_steps=6, max_chunks=3)
    assert tr.ada_state.stop_training and tr.chunk_runner.graph is not None
    assert tr.state.n_batches == tr.ada_state.last_modification_batch <= 2
    assert int(tr.chunk_runner.n_batches) == tr.state.n_batches
    # The run that stopped there, step by step.
    ref = narrow_trainer(cuda_device, tmp_path / "ref", adaptive_controller=ada)
    ref.fit(total_examples=10_000, max_steps=tr.state.n_batches)
    for (k, v), v2 in zip(ref.state.discriminator.state_dict().items(),
                          tr.state.discriminator.state_dict().values()):
        torch.testing.assert_close(v2, v, rtol=5e-4, atol=5e-5, msg=k)


def test_checkpoint_from_the_cpu_resumes_chunked_on_the_card(tmp_path, cuda_device):
    cpu = narrow_trainer("cpu", tmp_path)
    cpu.fit(total_examples=10_000, max_steps=2)
    card = narrow_trainer(cuda_device, tmp_path)
    assert card.state.n_batches == 2
    for group in card.state.d_opt.param_groups:
        assert not group["capturable"]  # fit's setting until the chunked mode runs
    card.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    assert card.state.n_batches == 4
    for opt in (card.state.g_opt, card.state.d_opt):
        assert all(group["capturable"] for group in opt.param_groups)
        assert all(s["step"].device.type == "cuda" for s in opt.state.values())
    assert all(torch.isfinite(p).all() for p in card.state.discriminator.parameters())


def test_runner_keeps_its_graph_until_the_state_moves(cuda_device, tmp_path):
    # A second call with the same dataset and chunk replays the same graph;
    # fit in between switches Adam back to non-capturable, which moves its
    # step counters, so the next call captures anew.
    tr = narrow_trainer(cuda_device, tmp_path)
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    runner, graph = tr.chunk_runner, tr.chunk_runner.graph
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    assert tr.chunk_runner is runner and runner.graph is graph
    tr.fit(total_examples=10_000, max_steps=1)
    assert not any(group["capturable"] for group in tr.state.d_opt.param_groups)
    del runner, graph
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    assert tr.chunk_runner.graph is not None and tr.state.n_batches == 7
    assert all(group["capturable"] for group in tr.state.d_opt.param_groups)
    assert all(torch.isfinite(p).all() for p in tr.state.discriminator.parameters())


def test_dropped_trainers_give_their_memory_back(cuda_device, tmp_path):
    # A CelebA-16 Trainer built, run in the chunked mode (its runner, dataset
    # copy and graphs on the card) and dropped, three times: after the first
    # round, which allocates what a process keeps for good, the allocated
    # bytes come back to the same level each time.
    import gc

    from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator

    levels = []
    for i in range(3):
        tr = narrow_trainer(cuda_device, tmp_path / f"round{i}",
                            GAN(celeba_generator(16), celeba_discriminator(16)))
        tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
        assert tr.chunk_runner.graph is not None
        tr.close()
        del tr
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        levels.append(torch.cuda.memory_allocated())
    assert all(abs(level - levels[0]) <= 2 ** 20 for level in levels[1:]), levels


@pytest.mark.parametrize("conv", [None, (1, 0, False), (2, 1, True), (1, 2, True)],
                         ids=["dense", "conv", "conv_transpose_s2", "conv_transpose_s1"])
def test_generator_product_backward_matches_the_cpu(cuda_device, conv):
    # The bfloat16 generator's product (models/dcgan.py _GeneratorProduct):
    # its float32 sums and both gradients on the card against the CPU's, at
    # the gradients' tolerance; the Dense's weight gradient is rounded to
    # bfloat16 on both, so one unit (2^-7 relative) apart at most.
    from blurred_gan_tpu_torch.models.dcgan import _generator_product

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 16) if conv is None else (2, 16, 6, 6), generator=gen)
    w = torch.randn((32, 16) if conv is None else (16, 8, 5, 5) if conv[2] else (8, 16, 5, 5),
                    generator=gen)
    out = {}
    for device in ("cpu", cuda_device):
        xd, wd = (t.to(device).requires_grad_(True) for t in (x, w))
        y = _generator_product(xd, wd, torch.bfloat16, True, conv)
        g = torch.linspace(-1, 1, y.numel(), device=device).reshape(y.shape)
        gx, gw = torch.autograd.grad(y, (xd, wd), g)
        out[str(device)] = [t.cpu() for t in (y, gx, gw)]
    (y, gx, gw), (y_c, gx_c, gw_c) = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(y_c, y, **FWD)
    torch.testing.assert_close(gx_c, gx, **GRAD)
    torch.testing.assert_close(gw_c, gw, **(dict(rtol=2 ** -7, atol=1e-5) if conv is None
                                            else GRAD))


def test_blur_ab_on_the_card(cuda_device, capsys):
    # bench --blur_ab at 64²: one line per arm, each correct on this card,
    # the kernel's arm launching the kernel (in its warm-up and capture).
    import json

    from blurred_gan_tpu_torch import bench

    before = blur_cuda.launch_count
    bench.main(["--blur_ab", "--resolutions", "64", "--min-seconds", "0.05"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [line["impl"] for line in lines] == ["torch", "cuda"]
    assert blur_cuda.launch_count - before >= 2 * bench.BLUR_AB_CHUNK
    for line in lines:
        assert line["correct"] is True and line["backend"] == "torch-cuda"
        assert line["device"] in torch.cuda.get_device_name(0) and line["us_per_blur"] > 0
