"""The train step (port of ``blurred_gan_tpu/train/step.py``).

One critic update, then one generator update through the *updated* critic, in
the JAX package's order:

1. uint8 NHWC reals -> float [-1, 1], NCHW, on the device; with
   ``flip_augment``, a per-sample mirror of the width axis;
2. ``z_d`` and fakes from the generator in eval mode, without gradient;
3. one critic call on ``cat([fakes, reals])`` with dropout on;
4. the gradient penalty through the eval-mode critic;
5. the critic's optimizer step;
6. the generator step: BatchNorm in train mode, eval-mode critic;
7. the generator's optimizer step, then the EMA of its parameters;
8. the counters.

Gradients are taken with ``torch.autograd.grad`` for exactly the parameters
being updated, so nothing piles up on the interpolates or on the critic during
the generator step.

The variants are the JAX step's:

- without ``gp_coefficient`` (``WGANHyperParameters``) the critic loss is the
  WGAN term alone, and ``gp_term`` and ``norm_term`` are 0;
- ``d_steps_per_g_step = D``: the generator step runs when
  ``n_batches % D == 0`` (the counter before the step); a skipped step reports
  ``gen_loss`` 0 and ``did_gen_step`` 0, and leaves the generator, its
  optimizer and its average alone;
- ``gp_every_n_steps = N`` (lazy GP): the penalty, scaled by N, runs when
  ``n_batches % N == 0``; the other steps build the loss without it;
- ``ema_decay = d``: ``ema ← ema·d + p·(1−d)`` after each generator update;
- ``g_learning_rate`` (TTUR) and ``optimizer`` live in the state's optimizers;
- ``flip_augment``: each real mirrored with probability 1/2;
- ``grad_accumulation_steps = K``: the batch in K microbatches, one optimizer
  update from the summed gradients, with the JAX step's exactness contract:
  ``z_d``, ``z_g`` and ``α`` are drawn for the full batch and sliced, the
  penalty and drift terms carry 1/K so that the summed microbatch losses are
  the full-batch loss, and generator BatchNorm normalises per microbatch, its
  running statistics carried from one to the next. The returned fakes are the
  microbatches' fakes, concatenated.

Where the JAX step selects with ``lax.cond`` (lazy GP, the generator gate) the
port selects on the host: :func:`step_phase` gives the ``(do_gp, do_gen)`` of
a step from its counter, and the body takes both as Python flags, so each
phase is a straight-line program that reads nothing back to the host. With
every field at its default there is one phase, and the body is the plain step.

Random draws come from ``state.rng`` reseeded from ``(seed, n_batches)``
every step, in this order:

- the flip mask, ``(B,)``, only with ``flip_augment`` (so the default stream
  is unchanged);
- ``z_d``, ``(B, latent)``;
- without accumulation: the dropout masks of the critic call, then the GP
  ``α`` ``(B, 1, 1, 1)`` (only on a step with the penalty);
- with accumulation: the full-batch ``α`` (only on a step with the penalty),
  then each microbatch's dropout masks in turn (the JAX step folds the
  microbatch index into its dropout key instead);
- ``z_g``, ``(B, latent)``, only on a step with the generator update.

A step can also take ``flip``, ``z_d``, ``z_g`` and ``alpha`` pinned through
``noise``, each on its own.

With bfloat16 networks (``--bf16``; ``models/dcgan.py``) the reals, the draws
and the pinned noise stay float32. ``torch.cat([fakes, reals])`` promotes
``--fast_gen``'s bfloat16 fakes to float32, as ``jnp.concatenate`` does, and
so do the penalty's interpolates, so their input gradient and its norm are
float32; the accumulated path's ``torch.cat`` of microbatch fakes keeps their
dtype, and the returned fakes are the generator's.

``make_step_body`` is the step without the reseed and the counters: it reads
nothing back to the host and keeps no host state, so it can be captured in a
CUDA graph (``train/fast.py``), one graph per phase, with σ as a device
tensor. Its caller reseeds ``state.rng`` before each call, picks the phase and
counts the steps.

``make_sample_fn`` is the eval-mode generator call behind sample grids and
evaluation, with the live weights or their average.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from blurred_gan_tpu_torch.losses.wgan import (
    wgan_discriminator_loss, wgan_generator_loss, wgangp_discriminator_loss)
from blurred_gan_tpu_torch.train.state import GAN, TrainState

Phase = Tuple[bool, bool]  # (do_gp, do_gen)


def step_seed(seed: int, n_batches: int) -> int:
    """Seed of the step whose pre-step counter is ``n_batches``: a pure
    function of both, so a run replays the same draws."""
    return int(np.random.SeedSequence([seed, n_batches]).generate_state(1, np.uint64)[0])


def _every(hparams, name: str) -> int:
    return int(getattr(hparams, name, 1) or 1)


def step_phase(hparams, n_batches: int) -> Phase:
    """``(do_gp, do_gen)`` of the step whose pre-step counter is
    ``n_batches``: whether it applies the gradient penalty, and whether it
    updates the generator."""
    use_gp = getattr(hparams, "gp_coefficient", None) is not None
    return (use_gp and n_batches % _every(hparams, "gp_every_n_steps") == 0,
            n_batches % _every(hparams, "d_steps_per_g_step") == 0)


def reachable_phases(hparams) -> List[Phase]:
    """Every phase a run of ``hparams`` takes, the full step first."""
    period = math.lcm(_every(hparams, "gp_every_n_steps"), _every(hparams, "d_steps_per_g_step"))
    return sorted({step_phase(hparams, n) for n in range(period)}, reverse=True)


def random_hflip(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mirror each NCHW image along its width with probability 1/2 (JAX
    ``random_hflip``, whose NHWC width axis this is). The ``(N,)`` bool
    ``mask`` of the flipped images is drawn from ``generator`` unless given.
    A ``torch.where`` on the device, with no host branch."""
    if mask is None:
        mask = torch.rand((images.shape[0],), generator=generator, device=images.device) < 0.5
    return torch.where(mask.to(images.device).reshape(-1, 1, 1, 1), images.flip(3), images)


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_step_body(gan: GAN, hparams):
    """Build ``body(state, reals, sigma, noise=None, *, do_gp=True,
    do_gen=True) -> (metrics, fakes)``: one step of the phase ``(do_gp,
    do_gen)`` that draws from ``state.rng`` as it stands and leaves the
    counters alone. ``sigma`` is a float or a 0-d float32 tensor on the
    device."""
    global_bs = float(hparams.global_batch_size)
    gp_coefficient = getattr(hparams, "gp_coefficient", None)
    use_gp = gp_coefficient is not None
    e_drift = float(getattr(hparams, "e_drift", 0.0))
    reference_grad_scale = bool(getattr(hparams, "reference_grad_scale", False))
    gp_every = _every(hparams, "gp_every_n_steps")
    # Lazy regularisation scales the applied penalty by its period, so the
    # time-averaged pressure matches every-step application.
    gp_scale = gp_every if use_gp and gp_every > 1 else 1
    ema_decay = float(getattr(hparams, "ema_decay", 0.0) or 0.0)
    flip_augment = bool(getattr(hparams, "flip_augment", False))
    accum = _every(hparams, "grad_accumulation_steps")
    if accum > 1 and reference_grad_scale:
        raise ValueError(
            "grad_accumulation_steps > 1 cannot reproduce the reference's ×B gradient "
            "(reference_grad_scale): the scale is per loss call, so microbatches would "
            "scale by B/K instead of B. Use one or the other.")
    consts: Dict[Tuple[float, torch.device], torch.Tensor] = {}

    def const(value: float, device) -> torch.Tensor:
        # Made once per device, at the first (eager) step, so a reported
        # constant costs a step no kernel.
        key = (value, device)
        if key not in consts:
            consts[key] = torch.full((), value, dtype=torch.float32, device=device)
        return consts[key]

    def disc_loss(reals, fakes, sigma, rng, alpha, with_gp: bool, term_scale: float):
        batch = reals.shape[0]
        scores = gan.critic(torch.cat([fakes, reals]), sigma, train=True, generator=rng)
        fake_scores, real_scores = scores[:batch], scores[batch:]
        if use_gp:
            loss, aux = wgangp_discriminator_loss(
                lambda x: gan.critic(x, sigma, train=False), reals, fakes,
                real_scores, fake_scores, rng, global_batch_size=global_bs,
                gp_coefficient=gp_coefficient * gp_scale * term_scale,
                e_drift=e_drift * term_scale, alpha=alpha,
                reference_grad_scale=reference_grad_scale, include_gp=with_gp)
        else:
            loss = wgan_discriminator_loss(real_scores, fake_scores, global_bs)
            zero = const(0.0, reals.device)
            aux = {"wgan_loss": loss, "gp_term": zero, "norm_term": zero}
        return loss, dict(aux, fake_scores=fake_scores.mean(), real_scores=real_scores.mean())

    def gen_loss(z, sigma):
        return wgan_generator_loss(gan.critic(gan.generate(z, train=True), sigma, train=False),
                                   global_bs)

    def summed(pieces):
        """Each microbatch's (loss, aux or None, grads) -> their sums."""
        loss, aux, grads = pieces[0]
        grads = list(grads)
        for loss_i, aux_i, grads_i in pieces[1:]:
            loss = loss + loss_i
            if aux is not None:
                aux = {k: v + aux_i[k] for k, v in aux.items()}
            torch._foreach_add_(grads, grads_i)
        return loss, aux, grads

    def body(state: TrainState, reals: torch.Tensor, sigma,
             noise: Optional[Dict[str, torch.Tensor]] = None, *,
             do_gp: bool = True, do_gen: bool = True):
        device = reals.device
        if reals.dtype == torch.uint8:
            reals = (reals.to(torch.float32) - 127.5) / 127.5
        reals = reals.permute(0, 3, 1, 2).contiguous()
        batch = reals.shape[0]
        if batch % accum:
            raise ValueError(f"global batch {batch} is not divisible by "
                             f"grad_accumulation_steps={accum}")
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
        rng = state.rng
        noise = noise or {}

        def drawn(name, shape):
            if name in noise:
                return torch.as_tensor(noise[name], dtype=torch.float32, device=device)
            return torch.rand(shape, generator=rng, device=device)

        if flip_augment:
            reals = random_hflip(reals, rng, noise.get("flip"))

        # ---- critic step, over K microbatches (K = 1: the batch itself) ----
        m = batch // accum
        z_d = drawn("z_d", (batch, gan.latent_size))
        # Unaccumulated, the penalty draws α itself, after the critic's dropout
        # (the default stream); accumulated, α is drawn for the full batch.
        alpha = (noise.get("alpha") if accum == 1
                 else drawn("alpha", (batch, 1, 1, 1)) if use_gp and do_gp else None)
        d_params = list(state.discriminator.parameters())
        pieces, micro_fakes = [], []
        for i in range(accum):
            mb = slice(i * m, (i + 1) * m)
            with torch.no_grad():
                micro_fakes.append(gan.generate(z_d[mb], train=False))
            loss_i, aux_i = disc_loss(reals[mb], micro_fakes[-1], sigma, rng,
                                      None if alpha is None else alpha[mb], do_gp, 1.0 / accum)
            pieces.append((loss_i, aux_i, torch.autograd.grad(loss_i, d_params)))
        d_loss, aux, d_grads = summed(pieces)
        fakes = micro_fakes[0] if accum == 1 else torch.cat(micro_fakes)
        if accum > 1:  # the score means summed over K equal microbatches
            aux["fake_scores"] = aux["fake_scores"] / accum
            aux["real_scores"] = aux["real_scores"] / accum
        _apply(state.d_opt, d_params, d_grads)

        # ---- generator step, through the updated critic ----
        if do_gen:
            z_g = drawn("z_g", (batch, gan.latent_size))
            g_params = list(state.generator.parameters())
            pieces = []
            for i in range(accum):
                loss_i = gen_loss(z_g[i * m:(i + 1) * m], sigma)
                pieces.append((loss_i, None, torch.autograd.grad(loss_i, g_params)))
            g_loss, _, g_grads = summed(pieces)
            _apply(state.g_opt, g_params, g_grads)
            if ema_decay > 0.0:
                with torch.no_grad():
                    # ema·d + p·(1−d), in the JAX step's order (lerp rounds
                    # otherwise).
                    torch._foreach_mul_(state.g_ema, ema_decay)
                    torch._foreach_add_(state.g_ema, torch._foreach_mul(g_params, 1.0 - ema_decay))
        else:
            g_loss = const(0.0, device)

        metrics = {"disc_loss": d_loss, "gen_loss": g_loss,
                   "did_gen_step": const(1.0 if do_gen else 0.0, device), "std": sigma, **aux}
        return {k: v.detach() for k, v in metrics.items()}, fakes

    return body


def make_train_step(gan: GAN, hparams, *, seed: int = 0):
    """Build ``step(state, reals, sigma, noise=None) -> (metrics, fakes)``.

    ``reals``: the NHWC batch on the device, uint8 or float in [-1, 1].
    ``sigma``: the blur σ for this step. ``noise``: optional dict with any of
    ``flip`` (B,) bool, ``z_d``, ``z_g`` (B, latent) and ``alpha`` (B, 1, 1, 1)
    tensors. ``metrics`` holds 0-d tensors; ``fakes`` are the critic step's
    NCHW fakes. The phase comes from ``state.n_batches``.
    """
    body = make_step_body(gan, hparams)

    def step(state: TrainState, reals: torch.Tensor, sigma,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        do_gp, do_gen = step_phase(hparams, state.n_batches)
        state.rng.manual_seed(step_seed(seed, state.n_batches))
        metrics, fakes = body(state, reals, sigma, noise, do_gp=do_gp, do_gen=do_gen)
        state.n_img += reals.shape[0]
        state.n_batches += 1
        return metrics, fakes

    return step


def make_sample_fn(gan: GAN, use_ema: bool = False):
    """``sample(state, latents) -> NCHW images``: the generator in eval mode
    (running BatchNorm statistics), without gradient. ``use_ema=True`` runs it
    with the weights of ``state.g_ema`` and the live BatchNorm statistics (the
    JAX package's convention: only the weights are averaged)."""

    @torch.no_grad()
    def sample(state: TrainState, latents: torch.Tensor) -> torch.Tensor:
        if not use_ema:
            return gan.generate(latents, train=False)
        if state.g_ema is None:
            raise ValueError("use_ema=True needs a state with g_ema (ema_decay > 0)")
        gan.generator.train(False)
        names = [n for n, _ in gan.generator.named_parameters()]
        return torch.func.functional_call(gan.generator, dict(zip(names, state.g_ema)),
                                          (latents,))

    return sample
