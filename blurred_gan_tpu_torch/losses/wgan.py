"""WGAN / WGAN-GP losses (port of ``blurred_gan_tpu/losses/wgan.py``).

- Losses are ``sum(...) / global_batch_size``.
- The gradient penalty interpolates *before* the blur (the critic callable
  holds the blur), evaluates the critic in inference mode, takes the input
  gradient with ``create_graph=True`` so the outer loss differentiates through
  it, and keeps ``+1e-12`` inside the square root.
- The drift term is a batch mean; ``reference_grad_scale`` multiplies the
  loss by the batch size.
- ``include_gp=False`` (the skipped steps of lazy regularisation) builds the
  loss without the penalty: no interpolates, no double backward, no draw of
  ``α``; ``gp_term`` is then a 0-d zero.
- ``α`` takes the reals' dtype; bfloat16 fakes meeting float32 reals give
  float32 interpolates, as ``jnp`` promotes them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def wgan_discriminator_loss(real_scores, fake_scores, global_batch_size):
    """sum(fake - real) / global_batch_size."""
    return torch.sum(fake_scores - real_scores) / global_batch_size


def wgan_generator_loss(fake_scores, global_batch_size):
    """-sum(fake) / global_batch_size."""
    return -torch.sum(fake_scores) / global_batch_size


def gradient_penalty(critic_fn: Callable, reals, fakes,
                     generator: Optional[torch.Generator] = None, *, alpha=None):
    """``mean((||∇ critic(x̂)|| - 1)²)`` at ``x̂ = reals + α (fakes - reals)``.

    ``α`` is drawn per sample, uniform in [0, 1), from ``generator`` unless
    ``alpha`` pins it (shape (B, 1, 1, 1)). Differentiable a second time.
    """
    batch = reals.shape[0]
    if alpha is None:
        a = torch.rand((batch, 1, 1, 1), generator=generator, device=reals.device,
                       dtype=reals.dtype)
    else:
        a = torch.as_tensor(alpha, dtype=reals.dtype, device=reals.device)
    with torch.enable_grad():
        x_hat = reals + a * (fakes - reals)
        if not x_hat.requires_grad:
            x_hat.requires_grad_(True)
        # Scores are per-sample independent, so the gradient of their sum is
        # each sample's own input gradient.
        (grads,) = torch.autograd.grad(torch.sum(critic_fn(x_hat)), x_hat,
                                       create_graph=True)
        norms = torch.sqrt(torch.sum(grads.reshape(batch, -1) ** 2, dim=1) + 1e-12)
        return torch.mean((norms - 1.0) ** 2)


def wgangp_discriminator_loss(critic_fn_eval: Callable, reals, fakes, real_scores,
                              fake_scores, generator: Optional[torch.Generator] = None,
                              *, global_batch_size, gp_coefficient=10.0,
                              e_drift=1e-4, alpha=None, reference_grad_scale=False,
                              include_gp=True):
    """Full WGAN-GP critic loss. Returns ``(loss, aux dict)``."""
    base = wgan_discriminator_loss(real_scores, fake_scores, global_batch_size)
    if include_gp:
        gp_term = gp_coefficient * gradient_penalty(critic_fn_eval, reals, fakes,
                                                    generator, alpha=alpha)
    else:
        gp_term = torch.zeros((), dtype=base.dtype, device=base.device)
    norm_term = e_drift * torch.mean(torch.abs(fake_scores) + torch.abs(real_scores))
    loss = base + gp_term + norm_term
    if reference_grad_scale:
        loss = loss * fake_scores.shape[0]
    return loss, {"wgan_loss": base, "gp_term": gp_term, "norm_term": norm_term}
