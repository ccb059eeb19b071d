"""The blurred WGAN-GP train step of the blurred-GAN reference, in float32,
with the rules that pick each step's batch, σ and random draws.

One step: a critic update on the WGAN-GP loss with drift, then a generator
update through the updated critic (``wgan.py``):

- reals uint8 NHWC → ``(x − 127.5) / 127.5``, NCHW;
- ``z_d`` uniform [0, 1); fakes from the generator in eval mode, no gradient;
- critic scores of ``blur(cat([fakes, reals]))`` in train mode (dropout);
- the penalty ``λ · mean((‖∇ critic(blur(x̂))‖ − 1)²)`` at
  ``x̂ = reals + α (fakes − reals)``, ``α`` uniform per image, the critic in
  eval mode, ``+1e−12`` inside the root, differentiated a second time;
- the critic loss ``sum(fake − real) / B + penalty + drift · mean(|fake| +
  |real|)``; Adam on the critic;
- ``z_g`` uniform; the generator in train mode (BatchNorm moves its running
  statistics), the updated critic in eval mode; the loss ``−sum(fake) / B``;
  Adam on the generator.

The draws come from one generator reseeded each step from ``(seed, step)``,
in this order: ``z_d``, the critic's dropout masks layer by layer, ``α``,
``z_g``. The batch of step ``n`` is slice ``n mod E`` (``E`` steps an epoch)
of the epoch's permutation ``RandomState(seed + epoch)``. σ decays per batch
as ``σ₀ · 0.96^(n / (total / 10))``, floored at 0.01.

Adam is tf.keras's: β 0.9 / 0.999, ε 1e−7 outside the root, bias-corrected.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import nets
from portbench.reference.blur import blur

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-7
SIGMA_DECAY_RATE = 0.96
SIGMA_MIN = 0.01


def step_seed(seed: int, n: int) -> int:
    return int(np.random.SeedSequence([seed, n]).generate_state(1, np.uint64)[0])


def batch_indices(num_examples: int, batch: int, n: int, seed: int) -> np.ndarray:
    per_epoch = max(num_examples // batch, 1)
    epoch, pos = divmod(n, per_epoch)
    return np.random.RandomState(seed + epoch).permutation(num_examples)[
        pos * batch:(pos + 1) * batch]


def decayed_sigma(sigma0: float, total_examples: int, n: int) -> float:
    sigma = sigma0 * SIGMA_DECAY_RATE ** (float(n) / (total_examples / 10))
    return float(np.float32(max(sigma, SIGMA_MIN)))


def unit_range(reals_u8: torch.Tensor) -> torch.Tensor:
    return ((reals_u8.to(torch.float32) - 127.5) / 127.5).permute(0, 3, 1, 2).contiguous()


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float):
        self.lr = lr
        self.t = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + ADAM_EPS))


class ReferenceGAN:
    """Both networks, their Adam states and the generator's running
    statistics, stepped by :meth:`step`."""

    def __init__(self, cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], device,
                 precision: str = "float32"):
        self.cfg = cfg
        self.precision = precision
        self.device = torch.device(device)
        out_ch = cfg["image_shape"][2]
        self.g_names = nets.parameter_names(
            nets.generator_shapes(cfg["generator"], cfg["latent_size"], out_ch))
        self.d_names = nets.parameter_names(nets.critic_shapes(cfg["critic"], cfg["image_shape"]))
        self.g = {k: v.detach().to(self.device, torch.float32).clone()
                  for k, v in weights["generator"].items()}
        self.d = {k: v.detach().to(self.device, torch.float32).clone()
                  for k, v in weights["critic"].items()}
        for k in self.g_names:
            self.g[k].requires_grad_(True)
        for k in self.d_names:
            self.d[k].requires_grad_(True)
        self.g_opt = Adam([self.g[k] for k in self.g_names], cfg["learning_rate"])
        self.d_opt = Adam([self.d[k] for k in self.d_names], cfg["learning_rate"])

    def _critic(self, images, sigma, train, rng=None):
        return nets.critic(self.d, blur(images, sigma), self.cfg["critic"], train=train,
                           precision=self.precision, rng=rng,
                           compute_dtype=self.cfg["compute_dtype"])

    def step(self, reals_u8: torch.Tensor, sigma: float, seed: int,
             rows: Optional[int] = None) -> Dict:
        """One step. Returns the critic step's fakes, the losses and score
        means as floats, and each network's gradients (``d_grads``,
        ``g_grads``, in name order).
        ``rows`` (a planted fault, for the controls) leaves out all but the
        batch's first ``rows`` rows after the generator: every fake of the
        batch is made (and returned), the critic step and the generator
        step take their means over the first ``rows`` reals and fakes."""
        cfg = self.cfg
        rng = torch.Generator(device=self.device).manual_seed(seed)
        reals = unit_range(reals_u8.to(self.device))
        latent = cfg["latent_size"]
        z_d = torch.rand((reals.shape[0], latent), generator=rng, device=self.device)
        with torch.no_grad():
            fakes = nets.generate(self.g, z_d, cfg["generator"], train=False,
                                  precision=self.precision)
        reals, fakes_d = reals[:rows], fakes[:rows]
        batch = reals.shape[0]
        scores = self._critic(torch.cat([fakes_d, reals]), sigma, True, rng)
        fake_s, real_s = scores[:batch], scores[batch:]
        alpha = torch.rand((batch, 1, 1, 1), generator=rng, device=self.device)
        x_hat = (reals + alpha * (fakes_d - reals)).requires_grad_(True)
        (gx,) = torch.autograd.grad(self._critic(x_hat, sigma, False).sum(), x_hat,
                                    create_graph=True)
        norms = torch.sqrt((gx.reshape(batch, -1) ** 2).sum(1) + 1e-12)
        gp = cfg["gp_coefficient"] * torch.mean((norms - 1.0) ** 2)
        wgan = torch.sum(fake_s - real_s) / batch
        drift = cfg["e_drift"] * torch.mean(fake_s.abs() + real_s.abs())
        d_loss = wgan + gp + drift
        d_params = [self.d[k] for k in self.d_names]
        d_grads = torch.autograd.grad(d_loss, d_params)
        self.d_opt.update(d_params, d_grads)

        z_g = torch.rand((reals_u8.shape[0], latent), generator=rng, device=self.device)
        new_stats: Dict[str, torch.Tensor] = {}
        fakes_g = nets.generate(self.g, z_g, cfg["generator"], train=True,
                                precision=self.precision, new_stats=new_stats)
        g_loss = -torch.sum(self._critic(fakes_g[:rows], sigma, False)) / batch
        g_params = [self.g[k] for k in self.g_names]
        g_grads = torch.autograd.grad(g_loss, g_params)
        self.g_opt.update(g_params, g_grads)
        self.g.update(new_stats)
        return {"fakes": fakes, "disc_loss": d_loss.item(), "gen_loss": g_loss.item(),
                "gp_term": gp.item(), "wgan_loss": wgan.item(), "norm_term": drift.item(),
                "fake_scores": fake_s.mean().item(), "real_scores": real_s.mean().item(),
                "d_grads": [g.detach() for g in d_grads],
                "g_grads": [g.detach() for g in g_grads]}

    def parameters(self) -> Dict[str, torch.Tensor]:
        """Every trained leaf, ``generator/<name>`` and ``critic/<name>``."""
        out = {f"generator/{k}": self.g[k].detach() for k in self.g_names}
        out.update({f"critic/{k}": self.d[k].detach() for k in self.d_names})
        return out
