"""The train step (port of ``blurred_gan_tpu/train/step.py``, default path).

One critic update, then one generator update through the *updated* critic, in
the JAX package's order:

1. uint8 NHWC reals -> float [-1, 1], NCHW, on the device;
2. ``z_d`` and fakes from the generator in eval mode, without gradient;
3. one critic call on ``cat([fakes, reals])`` with dropout on;
4. the gradient penalty through the eval-mode critic;
5. the critic's Adam step;
6. the generator step: BatchNorm in train mode, eval-mode critic;
7. the generator's Adam step;
8. the counters.

Gradients are taken with ``torch.autograd.grad`` for exactly the parameters
being updated, so nothing piles up on the interpolates or on the critic during
the generator step.

Random draws come from ``state.rng`` reseeded from ``(seed, n_batches)``
every step, in the order ``z_d``, dropout, GP ``alpha``, ``z_g``. A step can
also take ``z_d``, ``z_g`` and ``alpha`` pinned through ``noise``.

``make_step_body`` is the same step without the reseed and the counters: it
reads nothing back to the host and keeps no host state, so it can be captured
in a CUDA graph (``train/fast.py``) with σ as a device tensor. Its caller
reseeds ``state.rng`` before each call and counts the steps.

``make_sample_fn`` is the eval-mode generator call behind sample grids and
evaluation.

Not ported yet (ROADMAP queue 1, step variants): ``d_steps_per_g_step > 1``,
lazy GP, EMA, TTUR, flip augmentation, gradient accumulation, and the
penalty-free WGAN.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from blurred_gan_tpu_torch.losses.wgan import wgan_generator_loss, wgangp_discriminator_loss
from blurred_gan_tpu_torch.train.state import GAN, TrainState

_DEFAULT_PATH = (("d_steps_per_g_step", 1), ("gp_every_n_steps", 1),
                 ("ema_decay", 0.0), ("g_learning_rate", 0.0),
                 ("flip_augment", False), ("grad_accumulation_steps", 1))


def step_seed(seed: int, n_batches: int) -> int:
    """Seed of the step whose pre-step counter is ``n_batches``: a pure
    function of both, so a run replays the same draws."""
    return int(np.random.SeedSequence([seed, n_batches]).generate_state(1, np.uint64)[0])


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _check_default_path(hparams) -> None:
    for name, default in _DEFAULT_PATH:
        value = getattr(hparams, name, default)
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet; only {default!r} is "
                f"(ROADMAP queue 1, step variants)")
    if getattr(hparams, "gp_coefficient", None) is None:
        raise NotImplementedError(
            "the WGAN step without gradient penalty is not ported yet "
            "(ROADMAP queue 1, step variants)")


def make_step_body(gan: GAN, hparams):
    """Build ``body(state, reals, sigma, noise=None) -> (metrics, fakes)``: one
    step that draws from ``state.rng`` as it stands and leaves the counters
    alone. ``sigma`` is a float or a 0-d float32 tensor on the device."""
    _check_default_path(hparams)
    global_bs = float(hparams.global_batch_size)
    gp_coefficient = float(hparams.gp_coefficient)
    e_drift = float(hparams.e_drift)
    reference_grad_scale = bool(hparams.reference_grad_scale)

    def body(state: TrainState, reals: torch.Tensor, sigma,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        device = reals.device
        if reals.dtype == torch.uint8:
            reals = (reals.to(torch.float32) - 127.5) / 127.5
        reals = reals.permute(0, 3, 1, 2).contiguous()
        batch = reals.shape[0]
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
        rng = state.rng

        # ---- critic step ----
        z_d = noise["z_d"] if noise else gan.sample_latents(batch, rng, device)
        with torch.no_grad():
            fakes = gan.generate(z_d, train=False)
        scores = gan.critic(torch.cat([fakes, reals]), sigma, train=True, generator=rng)
        fake_scores, real_scores = scores[:batch], scores[batch:]
        d_loss, aux = wgangp_discriminator_loss(
            lambda x: gan.critic(x, sigma, train=False), reals, fakes,
            real_scores, fake_scores, rng, global_batch_size=global_bs,
            gp_coefficient=gp_coefficient, e_drift=e_drift,
            alpha=noise["alpha"] if noise else None,
            reference_grad_scale=reference_grad_scale)
        d_params = list(state.discriminator.parameters())
        _apply(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params))

        # ---- generator step, through the updated critic ----
        z_g = noise["z_g"] if noise else gan.sample_latents(batch, rng, device)
        g_scores = gan.critic(gan.generate(z_g, train=True), sigma, train=False)
        g_loss = wgan_generator_loss(g_scores, global_bs)
        g_params = list(state.generator.parameters())
        _apply(state.g_opt, g_params, torch.autograd.grad(g_loss, g_params))

        metrics = {"disc_loss": d_loss, "gen_loss": g_loss, "std": sigma,
                   "fake_scores": fake_scores.mean(), "real_scores": real_scores.mean(),
                   **aux}
        return {k: v.detach() for k, v in metrics.items()}, fakes

    return body


def make_train_step(gan: GAN, hparams, *, seed: int = 0):
    """Build ``step(state, reals, sigma, noise=None) -> (metrics, fakes)``.

    ``reals``: the NHWC batch on the device, uint8 or float in [-1, 1].
    ``sigma``: the blur σ for this step. ``noise``: optional dict with
    ``z_d``, ``z_g`` (B, latent) and ``alpha`` (B, 1, 1, 1) tensors.
    ``metrics`` holds 0-d tensors; ``fakes`` are the critic step's NCHW fakes.
    """
    body = make_step_body(gan, hparams)

    def step(state: TrainState, reals: torch.Tensor, sigma,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        state.rng.manual_seed(step_seed(seed, state.n_batches))
        metrics, fakes = body(state, reals, sigma, noise)
        state.n_img += reals.shape[0]
        state.n_batches += 1
        return metrics, fakes

    return step


def make_sample_fn(gan: GAN, use_ema: bool = False):
    """``sample(state, latents) -> NCHW images``: the generator in eval mode
    (running BatchNorm statistics), without gradient. ``use_ema=True`` would
    sample the EMA weights, which wait for the EMA step variant."""
    if use_ema:
        raise NotImplementedError(
            "sampling the EMA generator is not ported yet: the port has no EMA "
            "step variant (ROADMAP queue 1, step variants)")

    @torch.no_grad()
    def sample(state: TrainState, latents: torch.Tensor) -> torch.Tensor:
        return gan.generate(latents, train=False)

    return sample
