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

Data parallelism (a process group of N > 1, ``runtime.py``): each process
takes its 1/N of the global batch B (rows ``[r·b, (r+1)·b)`` of the global
batch for rank r and local batch b) and holds a whole replica of the state.

- Every draw is made at the global batch's shape from the identically
  seeded ``state.rng``, and each process keeps its own rows, so N processes
  consume the stream one process consumes: the flip mask, ``z_d``, ``z_g``,
  ``α`` and a pinned ``noise`` (given at the global shape). The critic's
  dropout masks are drawn for the global input ``cat([fakes, reals])`` (2B
  rows) and each process keeps its rows of both halves: N times the draws.
- The penalty's and the drift's batch means carry the weight 1/N
  (``losses/wgan.py``); the gradients are summed over the processes between
  ``torch.autograd.grad`` and the optimizer (``parallel.all_reduce_grads``),
  and the step's scalars are made global by one all-reduce. The generator's
  BatchNorm takes the global batch's statistics (``models/dcgan.py``).
- With ``grad_accumulation_steps = K`` the microbatches are the global
  batch's: microbatch i is global rows ``[i·B/K, (i+1)·B/K)``, of which each
  process takes ``B/(K·N)`` at its rank's offset (the JAX sharded
  ``step_accum``). The processes gather the reals first (uint8 until then,
  B images) since a microbatch's rows come from several processes' shards.
- ``n_img`` counts global examples.

With one process every one of these is the plain step, to the bit.

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
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from blurred_gan_tpu_torch import parallel
from blurred_gan_tpu_torch.losses.wgan import (
    wgan_discriminator_loss, wgan_generator_loss, wgangp_discriminator_loss)
from blurred_gan_tpu_torch.runtime import process_count, process_index
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


def phase_shares(hparams) -> Dict[Phase, Fraction]:
    """The share of a run's steps that each phase takes, in closed form (no
    loop over a period, which for ``d_steps_per_g_step = 10**9`` is a
    billion counters): of ``P = lcm(g, d)`` steps (``g`` the penalty's
    period, 1 without it; ``d`` the generator's), the multiples of both are
    ``P/P``, of ``g`` alone ``P/g − 1``, of ``d`` alone ``P/d − 1``, of
    neither the rest. A phase no counter takes has share 0."""
    use_gp = getattr(hparams, "gp_coefficient", None) is not None
    g = _every(hparams, "gp_every_n_steps") if use_gp else 1
    d = _every(hparams, "d_steps_per_g_step")
    both = Fraction(1, math.lcm(g, d))
    shares: Dict[Phase, Fraction] = {}
    for (gp, gen), share in (((True, True), both), ((True, False), Fraction(1, g) - both),
                             ((False, True), Fraction(1, d) - both),
                             ((False, False), 1 - Fraction(1, g) - Fraction(1, d) + both)):
        phase = (use_gp and gp, gen)
        shares[phase] = shares.get(phase, Fraction(0)) + share
    return shares


def reachable_phases(hparams) -> List[Phase]:
    """Every phase a run of ``hparams`` takes, the full step first: ``(use_gp,
    True)`` at counter 0; ``(True, False)`` iff the penalty is on and ``d``
    does not divide ``g``; ``(False, True)`` iff it is on and ``g`` does not
    divide ``d``; ``(False, False)`` iff ``d > 1`` and either ``g > 1`` or
    the penalty is off (:func:`phase_shares`)."""
    return sorted((p for p, share in phase_shares(hparams).items() if share), reverse=True)


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
    world, rank = process_count(), process_index()
    dp = world > 1
    replica_weight = 1.0 / world if dp else None
    consts: Dict[Tuple[float, torch.device], torch.Tensor] = {}

    def const(value: float, device) -> torch.Tensor:
        # Made once per device, at the first (eager) step, so a reported
        # constant costs a step no kernel.
        key = (value, device)
        if key not in consts:
            consts[key] = torch.full((), value, dtype=torch.float32, device=device)
        return consts[key]

    def disc_loss(reals, fakes, sigma, rng, alpha, with_gp: bool, term_scale: float,
                  rows=None):
        batch = reals.shape[0]
        scores = gan.critic(torch.cat([fakes, reals]), sigma, train=True, generator=rng,
                            rows=rows)
        fake_scores, real_scores = scores[:batch], scores[batch:]
        if use_gp:
            if rows is not None and alpha is None and with_gp:
                # α for the global rows, drawn where the penalty draws it.
                alpha = torch.rand((rows[0] // 2, 1, 1, 1), generator=rng,
                                   device=reals.device, dtype=reals.dtype)[rows[1][:batch]]
            loss, aux = wgangp_discriminator_loss(
                lambda x: gan.critic(x, sigma, train=False), reals, fakes,
                real_scores, fake_scores, rng, global_batch_size=global_bs,
                gp_coefficient=gp_coefficient * gp_scale * term_scale,
                e_drift=e_drift * term_scale, alpha=alpha,
                reference_grad_scale=reference_grad_scale, include_gp=with_gp,
                replica_weight=replica_weight)
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
        batch = reals.shape[0] * world  # the global batch
        if batch % accum:
            raise ValueError(f"global batch {batch} is not divisible by "
                             f"grad_accumulation_steps={accum}")
        m = batch // accum  # a microbatch's global rows
        if m % world:
            raise ValueError(f"a microbatch of {m} does not split over {world} processes")
        per = m // world  # this process's rows of each microbatch
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
        rng = state.rng
        noise = noise or {}

        def drawn(name, shape):
            if name in noise:
                return torch.as_tensor(noise[name], dtype=torch.float32, device=device)
            return torch.rand(shape, generator=rng, device=device)

        def mine(t, i):
            """This process's rows of microbatch ``i`` of a global-batch tensor."""
            start = i * m + rank * per
            return t[start:start + per]

        if dp and accum > 1:
            reals = parallel.all_gather_rows(reals)
        # Unaccumulated, a process's reals are its rows of the one microbatch.
        local_reals = (lambda i: reals) if dp and accum == 1 else (lambda i: mine(reals, i))
        if flip_augment:
            mask = noise.get("flip")
            if mask is None:
                mask = torch.rand((batch,), generator=rng, device=device) < 0.5
            reals = random_hflip(reals, mask=mine(mask, 0) if dp and accum == 1 else mask)
        rows = (2 * m, parallel.replica_rows(per, m).to(device)) if dp else None

        # ---- critic step, over K microbatches (K = 1: the batch itself) ----
        z_d = drawn("z_d", (batch, gan.latent_size))
        # Unaccumulated, the penalty draws α itself, after the critic's dropout
        # (the default stream); accumulated, α is drawn for the full batch.
        alpha = (noise.get("alpha") if accum == 1
                 else drawn("alpha", (batch, 1, 1, 1)) if use_gp and do_gp else None)
        d_params = list(state.discriminator.parameters())
        pieces, micro_fakes = [], []
        for i in range(accum):
            with torch.no_grad():
                micro_fakes.append(gan.generate(mine(z_d, i), train=False))
            loss_i, aux_i = disc_loss(local_reals(i), micro_fakes[-1], sigma, rng,
                                      None if alpha is None else mine(alpha, i), do_gp,
                                      1.0 / accum, rows)
            pieces.append((loss_i, aux_i, torch.autograd.grad(loss_i, d_params)))
        d_loss, aux, d_grads = summed(pieces)
        fakes = micro_fakes[0] if accum == 1 else torch.cat(micro_fakes)
        if accum > 1:  # the score means summed over K equal microbatches
            aux["fake_scores"] = aux["fake_scores"] / accum
            aux["real_scores"] = aux["real_scores"] / accum
        _apply(state.d_opt, d_params, parallel.all_reduce_grads(d_grads))

        # ---- generator step, through the updated critic ----
        if do_gen:
            z_g = drawn("z_g", (batch, gan.latent_size))
            g_params = list(state.generator.parameters())
            pieces = []
            for i in range(accum):
                loss_i = gen_loss(mine(z_g, i), sigma)
                pieces.append((loss_i, None, torch.autograd.grad(loss_i, g_params)))
            g_loss, _, g_grads = summed(pieces)
            _apply(state.g_opt, g_params, parallel.all_reduce_grads(g_grads))
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
        metrics = parallel.all_reduce_metrics({k: v.detach() for k, v in metrics.items()})
        return metrics, fakes

    return body


def make_train_step(gan: GAN, hparams, *, seed: int = 0):
    """Build ``step(state, reals, sigma, noise=None) -> (metrics, fakes)``.

    ``reals``: the NHWC batch on the device, uint8 or float in [-1, 1].
    ``sigma``: the blur σ for this step. ``noise``: optional dict with any of
    ``flip`` (B,) bool, ``z_d``, ``z_g`` (B, latent) and ``alpha`` (B, 1, 1, 1)
    tensors. ``metrics`` holds 0-d tensors; ``fakes`` are the critic step's
    NCHW fakes. The phase comes from ``state.n_batches``. In a data-parallel
    run ``reals`` is this process's share, ``noise`` the global batch's, and
    ``fakes`` this process's.
    """
    body = make_step_body(gan, hparams)
    world = process_count()

    def step(state: TrainState, reals: torch.Tensor, sigma,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        do_gp, do_gen = step_phase(hparams, state.n_batches)
        state.rng.manual_seed(step_seed(seed, state.n_batches))
        metrics, fakes = body(state, reals, sigma, noise, do_gp=do_gp, do_gen=do_gen)
        state.n_img += reals.shape[0] * world
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
