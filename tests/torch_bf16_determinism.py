"""Does one train step repeat to the bit on the card? Four first steps of
each precision of ``chip_smoke.py``'s phase 13 (float32, ``--bf16``,
``--bf16 --fast_gen``: the kernel, the plain blur, the kernel, the plain
blur) from fresh entry-point trainers with the same weights, draws and
reals, with cuDNN's default algorithms and then under deterministic cuDNN.
One JSON line a step: its losses, the critic's gradient norm and the sum of
the critic's parameters after it. An experiment harness, not a test.

    python tests/torch_bf16_determinism.py .                # this checkout's package
    python tests/torch_bf16_determinism.py results/parent   # another tree's

It imports torch and the port only (and ``chip_smoke.py`` of this checkout
for the smoke configuration), so it runs on the card's machine.
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    sys.path.insert(0, root)
    import blurred_gan_tpu_torch
    from blurred_gan_tpu_torch.entry import set_float32_precision
    from blurred_gan_tpu_torch.ops import blur_cuda
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    if not blurred_gan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {blurred_gan_tpu_torch.__file__}, not the one under {root}")
    set_float32_precision()
    blur_cuda.build()
    keys = ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores", "real_scores")
    with tempfile.TemporaryDirectory() as workdir:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            for name, flags in cs.PRECISIONS:
                reals = None
                for run, impl in enumerate(("cuda", "torch", "cuda", "torch")):
                    trainer, _ = build_trainer(cs.smoke_args(
                        os.path.join(workdir, f"{deterministic}_{name}_{run}"), **flags),
                        feeders=[])
                    if reals is None:
                        reals = torch.from_numpy(
                            next(trainer.dataset.batches(cs.BATCH, seed=1))).to("cuda")
                    trainer.gan.blur_impl = impl
                    with cs.recorded_critic_grad_norms(trainer.state) as norms:
                        metrics, _ = trainer.step_fn(trainer.state, reals, cs.SIGMA0)
                    params = torch.cat([p.detach().flatten().double()
                                        for p in trainer.state.discriminator.parameters()])
                    print(json.dumps({"package": root, "deterministic": deterministic,
                                      "config": name, "impl": impl, "run": run,
                                      "critic_grad_norm": norms[0],
                                      "critic_param_sum": float(params.sum()),
                                      **{k: float(metrics[k]) for k in keys}}), flush=True)
                    trainer.close()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else REPO)
