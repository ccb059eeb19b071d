"""The quality check on the synthetic corpus: ``train`` one arm (the port's
counterpart of ``benchmarks/quality_parity.py train_ours``) and
``evaluate`` the sample sets (of its ``evaluate``).

One run trains the configuration's networks with ``Trainer.fit`` (the host
loop, the blur kernel on the card) for ``--examples`` images of the seeded
synthetic corpus under the open-loop σ schedule, or the closed-loop
controller with ``--adaptive``, then samples 1000 images from the fixed eval
latents (``RandomState(123)``) with the eval-mode generator, the averaged
weights for ``--ema_decay``, and writes

- ``<out>/<prefix>_samples_s<seed>.npz``: ``samples``, NHWC float32 in
  [-1, 1], the layout of the JAX package's sample sets;
- ``<out>/<prefix>_meta_s<seed>.json``: ``train_ours``'s keys, the arm's
  own, ``"framework": "blurred_gan_tpu_torch"``, and the device's name and
  power limit;
- ``<out>/<prefix>_log_s<seed>/``: the run directory (events, the final
  checkpoint).

The prefix is ``train_ours``'s with ``ours`` replaced by ``torch``: ``torch``,
``torch_bf16``, ``torch_ema``, ``torch_adaptive``, ``torch_refscale``,
``torch_resize``, ``torch_ttur`` or ``torch_d<N>``; one arm a run. Float32
arms run without TF32; ``--bf16`` computes both networks in bfloat16 (not
``--fast_gen``). The repo root's ``quality_torch_score.py`` scores the sample
sets with the JAX package's metrics against the recorded JAX arms.

    python -m blurred_gan_tpu_torch.quality train --config mnist --examples 180000 \\
        --seed 0 --out runs/quality/mnist [--bf16 | --ema_decay 0.999 | --adaptive | ...]
    python -m blurred_gan_tpu_torch.quality train --config mnist --examples 64 \\
        --out /tmp/q --device cpu

``evaluate`` (the counterpart of ``quality_parity.py evaluate``) scores every
``torch[_<arm>]_samples_s<seed>.npz`` of ``--dir`` (``--out`` by default) for
``--seeds`` with the port's metrics on ``--device``: ``evaluate``'s row (SWD
levels and average, random-conv and Inception FID at 75², PRDC with k = 5,
KID over subsets of 500; the same rounding) against the same held-out reals,
a reals-vs-reals floor row first. Then each arm's per-seed relative gap
against the plain ``torch`` run of its seed and, with ``--pool``, the pooled
statistics over the seeds; ``--rows_from`` merges the rows of earlier runs.
Every row says which metric stack scored it (``"stack": "torch-cuda"``,
``"torch-cpu"``; the JAX package's rows are ``"jax"``, with or without the
field): the port draws its SWD patches and projections and its random-conv
extractor from ``torch.Generator`` streams, so only gaps inside one stack
mean anything, and rows of two stacks are never merged, gapped or pooled:

    python -m blurred_gan_tpu_torch.quality evaluate --config celeba64 \\
        --dir runs/quality/celeba64 --seeds 6,7,8 --pool [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.entry import device_fields, setup_device
from blurred_gan_tpu_torch.metrics.fid import FIDMetric, random_conv_features
from blurred_gan_tpu_torch.metrics.inception import inception_feature_fn
from blurred_gan_tpu_torch.metrics.kid import kid_from_images
from blurred_gan_tpu_torch.metrics.prdc import prdc_from_images
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.models.dcgan import (
    celeba_discriminator, celeba_generator, mnist_discriminator, mnist_generator)
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN
from blurred_gan_tpu_torch.train.step import make_sample_fn

BATCH = 32
LATENT = 100
N_EVAL = 1000
SAMPLE_CHUNK = 100  # eval latents a generator call takes


@dataclasses.dataclass(frozen=True)
class ParityConfig:
    """A surface of the quality check: the corpus's image shape and size,
    σ₀ of the schedule, and the networks' key (the name by default)."""

    name: str
    image_shape: tuple
    corpus_n: int
    sigma0: float
    arch: str = ""

    def __post_init__(self):
        if not self.arch:
            object.__setattr__(self, "arch", self.name)


CONFIGS = {
    "mnist": ParityConfig("mnist", (28, 28, 1), 60_000, 0.05),
    "celeba64": ParityConfig("celeba64", (64, 64, 3), 20_000, 5.0),
    "celeba128": ParityConfig("celeba128", (128, 128, 3), 20_000, 5.0),
    # The sharp regime: σ₀ 0.05 on the CelebA-64 and -128 networks.
    "celeba64_sharp": ParityConfig("celeba64_sharp", (64, 64, 3), 20_000, 0.05,
                                   arch="celeba64"),
    "celeba128_sharp": ParityConfig("celeba128_sharp", (128, 128, 3), 20_000, 0.05,
                                    arch="celeba128"),
}


def eval_latents(seed: int = 123) -> np.ndarray:
    """The 1000 uniform [0, 1) latents every arm samples its eval set from."""
    return np.random.RandomState(seed).rand(N_EVAL, LATENT).astype(np.float32)


@functools.lru_cache(maxsize=1)
def corpus(cfg: ParityConfig):
    """The configuration's synthetic corpus (byte-equal to the JAX package's),
    kept for the next run of the same configuration in this process (it is
    never written to)."""
    return synthetic_dataset(cfg.image_shape, num_examples=cfg.corpus_n)


def networks(cfg: ParityConfig, compute_dtype: torch.dtype = torch.float32,
             upsample: str = "transpose"):
    """(generator, critic) of the configuration's architecture."""
    if cfg.arch == "mnist":
        return (mnist_generator(compute_dtype=compute_dtype, upsample=upsample),
                mnist_discriminator(compute_dtype=compute_dtype))
    res = cfg.image_shape[0]
    return (celeba_generator(res, compute_dtype=compute_dtype, upsample=upsample),
            celeba_discriminator(res, compute_dtype=compute_dtype))


def arm_prefix(*, ema_decay: float = 0.0, bf16: bool = False, adaptive: bool = False,
               ref_grad_scale: bool = False, gen_upsample: str = "transpose",
               ttur_g_lr: float = 0.0, d_steps: int = 1) -> str:
    """The files' prefix of the arm these flags select; more than one arm is
    refused (an arm pairs with the plain run of the same seed)."""
    arms = [bool(bf16), bool(ema_decay), bool(adaptive), bool(ref_grad_scale),
            gen_upsample != "transpose", bool(ttur_g_lr), d_steps != 1]
    if sum(arms) > 1:
        raise SystemExit("pick one arm per run: --bf16 | --ema_decay | --adaptive | "
                         "--ref_grad_scale | --gen_upsample | --ttur_g_lr | --d_steps "
                         "(arms pair 1:1 against the plain run)")
    return ("torch_adaptive" if adaptive else
            "torch_bf16" if bf16 else
            "torch_ema" if ema_decay else
            "torch_refscale" if ref_grad_scale else
            "torch_resize" if gen_upsample != "transpose" else
            "torch_ttur" if ttur_g_lr else
            f"torch_d{d_steps}" if d_steps != 1 else
            "torch")


def eval_samples(gan: GAN, state, *, use_ema: bool, latents: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """The eval-mode generator's images of ``latents`` (the eval latents by
    default), ``SAMPLE_CHUNK`` a call: NHWC float32 numpy in [-1, 1]."""
    latents = eval_latents() if latents is None else latents
    sample = make_sample_fn(gan, use_ema=use_ema)
    device = next(gan.generator.parameters()).device
    chunks = [sample(state, torch.from_numpy(latents[i:i + SAMPLE_CHUNK]).to(device))
              for i in range(0, len(latents), SAMPLE_CHUNK)]
    return torch.cat(chunks).permute(0, 2, 3, 1).to(torch.float32).cpu().numpy()


def train(cfg: ParityConfig, examples: int, out: str, seed: int, *,
          ema_decay: float = 0.0, bf16: bool = False, adaptive: bool = False,
          ref_grad_scale: bool = False, gen_upsample: str = "transpose",
          ttur_g_lr: float = 0.0, d_steps: int = 1, device: str = "cuda",
          concurrent_runs: int = 1,
          on_trainer: Optional[Callable[[Trainer], None]] = None) -> dict:
    """Train one arm and write its sample set and meta; returns the meta.

    ``concurrent_runs`` > 1 records that this many runs shared the device
    (their ``images_per_sec`` is then no speed reading). ``on_trainer`` is
    called with the ``Trainer`` before it fits."""
    prefix = arm_prefix(ema_decay=ema_decay, bf16=bf16, adaptive=adaptive,
                        ref_grad_scale=ref_grad_scale, gen_upsample=gen_upsample,
                        ttur_g_lr=ttur_g_lr, d_steps=d_steps)
    dev = setup_device(device)
    gen, disc = networks(cfg, torch.bfloat16 if bf16 else torch.float32, gen_upsample)
    gan = GAN(gen, disc, blurred=True)
    hp = BlurredWGANGPHyperParameters(batch_size=BATCH, global_batch_size=BATCH,
                                      ema_decay=ema_decay,
                                      reference_grad_scale=ref_grad_scale,
                                      g_learning_rate=ttur_g_lr, d_steps_per_g_step=d_steps)
    if adaptive:
        open_ctrl = None
        ada_ctrl = AdaptiveBlurController(max_value=cfg.sigma0, apply_changes=True)
    else:
        open_ctrl = BlurDecayController(total_n_training_examples=examples,
                                        max_value=cfg.sigma0)
        ada_ctrl = None
    tr = Trainer(gan, hp, corpus(cfg), device=dev,
                 trainer_config=TrainerConfig(
                     log_dir=os.path.join(out, f"{prefix}_log_s{seed}"), seed=seed,
                     sample_grid_every_n_examples=0, checkpoint_every_n_examples=0,
                     image_summaries_interval_batches=0,
                     # A hung card fails the seed instead of stalling a sweep.
                     device_fetch_timeout_s=120.0 if dev.type == "cuda" else 0.0),
                 blur_controller=open_ctrl, adaptive_controller=ada_ctrl)
    if on_trainer is not None:
        on_trainer(tr)
    t0 = time.time()
    state = tr.fit(total_examples=examples)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0

    samples = eval_samples(gan, state, use_ema=bool(ema_decay))
    tr.close()
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"{prefix}_samples_s{seed}.npz"), samples=samples)
    meta = {"framework": "blurred_gan_tpu_torch", "config": cfg.name, "seed": seed,
            "examples": examples, "backend": f"torch-{dev.type}",
            "ema_decay": ema_decay, "compute_dtype": "bfloat16" if bf16 else "float32",
            "images_per_sec": round(state.n_img / elapsed, 2),
            "elapsed_s": round(elapsed, 1), **device_fields(dev)}
    if concurrent_runs > 1:
        meta["concurrent_runs"] = concurrent_runs
    if ref_grad_scale:
        meta["reference_grad_scale"] = True
    if gen_upsample != "transpose":
        meta["gen_upsample"] = gen_upsample
    if ttur_g_lr:
        meta["ttur_g_lr"] = ttur_g_lr
    if d_steps != 1:
        meta["d_steps_per_g_step"] = d_steps
    if adaptive:
        meta.update(sigma_final=round(float(tr.ada_state.std), 5),
                    examples_trained=int(state.n_img),
                    stopped_early=bool(tr.ada_state.stop_training))
    with open(os.path.join(out, f"{prefix}_meta_s{seed}.json"), "w") as f:
        json.dump(meta, f)
    print(json.dumps(meta), flush=True)
    return meta


# ---------------------------------------------------------------------------
# evaluate: the port's copy of quality_parity.py's scoring
# ---------------------------------------------------------------------------

# The arms evaluate scores, in quality_parity.evaluate's order.
ARMS = ("torch", "torch_ema", "torch_bf16", "torch_adaptive", "torch_refscale",
        "torch_resize", "torch_ttur", "torch_d2")
JAX_STACK = "jax"


def held_out_reals(cfg: ParityConfig):
    """(reals, floor reals): the last and the first ``N_EVAL`` images of the
    ``RandomState(10_000)`` shuffle of the corpus, NHWC float32 in [-1, 1]."""
    images = corpus(cfg).images
    order = np.random.RandomState(10_000).permutation(len(images))
    return (images[order[-N_EVAL:]].astype(np.float32) / 127.5 - 1.0,
            images[order[:N_EVAL]].astype(np.float32) / 127.5 - 1.0)


def make_scorer(reals: np.ndarray, device, *, use_inception: bool = True,
                inception_size: int = 75, swd_metric: Callable[[], SWDMetric] = SWDMetric,
                extractor: Optional[Callable] = None,
                fid_extractors: Optional[Dict[str, Callable]] = None
                ) -> Callable[[str, np.ndarray], dict]:
    """``score(name, fakes) -> row``: ``evaluate``'s row of NHWC ``fakes``
    against ``reals`` (batches of 100 on ``device``), with its ``stack``.

    ``extractor`` (by default the seed-0 random-conv embedding, 2048
    features) serves PRDC, KID and the random-conv FID, as the one each
    builds in ``evaluate``; the Inception FID's trunk runs at
    ``inception_size``. ``swd_metric``, ``extractor`` and ``fid_extractors``
    (``{row key: extractor}``) replace the port's own draws (the tests hand
    it the JAX package's)."""
    device = torch.device(device)
    stack = f"torch-{device.type}"
    n = len(reals)
    reals_t = _nchw(reals, device)
    if extractor is None:
        extractor = random_conv_features(tuple(reals_t.shape[1:]), dim=2048, device=device)
    if fid_extractors is None:
        fid_extractors = {"fid_randconv": extractor}
        if use_inception:
            fid_extractors["fid_inception"] = inception_feature_fn(
                resize_to=inception_size, device=device)

    def score(name: str, fakes: np.ndarray) -> dict:
        fakes_t = _nchw(fakes, device)
        row = {"samples": name}
        swd = swd_metric()
        for i in range(0, n, SAMPLE_CHUNK):
            swd.update_state(reals_t[i:i + SAMPLE_CHUNK], fakes_t[i:i + SAMPLE_CHUNK])
        row.update({k: round(float(v), 3) for k, v in swd.results().items()})
        for fid_name, fn in fid_extractors.items():
            fid = FIDMetric(feature_fn=fn)
            for i in range(0, n, SAMPLE_CHUNK):
                fid.update_state(reals_t[i:i + SAMPLE_CHUNK], fakes_t[i:i + SAMPLE_CHUNK])
            row[fid_name] = round(float(fid.result()), 3)
        row.update({k: round(v, 4) for k, v in prdc_from_images(
            reals_t, fakes_t, feature_fn=extractor, k=5, batch=SAMPLE_CHUNK).items()})
        row.update({k: round(v, 5) for k, v in kid_from_images(
            reals_t, fakes_t, feature_fn=extractor, subset_size=500,
            batch=SAMPLE_CHUNK).items()})
        row["stack"] = stack
        print(json.dumps(row), flush=True)
        return row

    return score


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images, np.float32)).permute(
        0, 3, 1, 2).contiguous().to(device)


def row_stack(row: dict) -> str:
    """The metric stack that scored ``row`` (the JAX package's rows carry none)."""
    return row.get("stack", JAX_STACK)


def _same_stack(*rows: dict) -> None:
    stacks = {row_stack(r) for r in rows}
    if len(stacks) > 1:
        raise ValueError(f"rows of different metric stacks {sorted(stacks)} "
                         f"({', '.join(r.get('samples', '?') for r in rows)}): their "
                         "absolute values are not comparable")


def is_quality_metric(key: str) -> bool:
    """The lower-is-better scores: SWD levels and average, both FIDs, KID
    (``kid_std`` and PRDC are diagnostics)."""
    return key == "kid" or key.lower().startswith(("swd", "fid"))


def rel_gaps(a: dict, b: dict) -> Dict[str, float]:
    """(b − a) / |a| for each quality metric of two rows of one stack
    (positive: b worse)."""
    _same_stack(a, b)
    return {k: round((b[k] - a[k]) / abs(a[k]), 4)
            for k in a if is_quality_metric(k) and k in b and a[k] != 0}


def pooled_stats(rows: dict, seeds, side_a: str, side_b: str) -> Optional[dict]:
    """``quality_parity._pooled_stats``: medians, means, their relative gaps
    (positive: B worse) and per-seed wins over every seed where both sides
    scored, or None below two such seeds. Both sides' rows must be of one
    stack."""
    paired = [s for s in seeds if f"{side_a}_s{s}" in rows and f"{side_b}_s{s}" in rows]
    if len(paired) < 2:
        return None
    _same_stack(*(rows[f"{side}_s{s}"] for s in paired for side in (side_a, side_b)))
    metrics = [k for k in rows[f"{side_a}_s{paired[0]}"] if is_quality_metric(k)]
    pooled, wins = {}, {side_a: 0, side_b: 0, "ties": 0}
    for m in metrics:
        a = np.array([rows[f"{side_a}_s{s}"][m] for s in paired], float)
        b = np.array([rows[f"{side_b}_s{s}"][m] for s in paired], float)
        med_a, med_b = float(np.median(a)), float(np.median(b))
        w_a, w_b = int(np.sum(b > a)), int(np.sum(a > b))
        ties = len(paired) - w_a - w_b
        wins[side_a] += w_a
        wins[side_b] += w_b
        wins["ties"] += ties
        pooled[m] = {
            f"median_{side_a}": round(med_a, 4),
            f"median_{side_b}": round(med_b, 4),
            "rel_gap_median": round((med_b - med_a) / abs(med_a), 4) if med_a else None,
            f"mean_{side_a}": round(float(a.mean()), 4),
            f"mean_{side_b}": round(float(b.mean()), 4),
            "rel_gap_mean": (round(float(b.mean() - a.mean()) / abs(float(a.mean())), 4)
                             if a.mean() else None),
            "wins": f"{side_a} {w_a} / {side_b} {w_b}" + (f" / tie {ties}" if ties else ""),
        }
    return {"pooled": f"{side_b}_vs_{side_a}", "n_paired_seeds": len(paired),
            "seeds": paired, "stats": pooled, "total_wins_of_all_comparisons": wins}


def merge_recorded_rows(rows: dict, paths, stack: str) -> None:
    """``quality_parity._merge_recorded_rows``: fill the ``<arm>_s<seed>``
    rows absent from ``rows`` from earlier runs' JSONL (rows scored now win).
    A row of another stack than ``stack`` is refused."""
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                name = row.get("samples", "")
                if "_s" in name and name not in rows and name != "reals_vs_reals":
                    if row_stack(row) != stack:
                        raise ValueError(f"{path}: row {name} was scored by the "
                                         f"{row_stack(row)!r} stack, this run by {stack!r}: "
                                         "rows of two stacks are not merged")
                    rows[name] = row
                    print(json.dumps({"merged_recorded_row": name, "from": path}), flush=True)


def evaluate(cfg: ParityConfig, directory: str, seeds: Sequence[int], *,
             device: str = "cuda", use_inception: bool = True, inception_size: int = 75,
             pool: bool = False, rows_from: Sequence[str] = ()) -> dict:
    """Score every arm's sample set of ``seeds`` in ``directory`` on
    ``device``, merge ``rows_from``, print the per-seed gaps against the
    plain run and, with ``pool``, the pooled statistics; returns the rows
    (``reals_floor`` first)."""
    dev = setup_device(device)
    reals, reals_b = held_out_reals(cfg)
    score = make_scorer(reals, dev, use_inception=use_inception, inception_size=inception_size)
    rows = {"reals_floor": score("reals_vs_reals", reals_b)}
    for seed in seeds:
        for arm in ARMS:
            path = os.path.join(directory, f"{arm}_samples_s{seed}.npz")
            if not os.path.exists(path):
                if arm == "torch":
                    print(f"[skip] {path} missing", flush=True)
                continue
            with np.load(path) as d:
                rows[f"{arm}_s{seed}"] = score(f"{arm}_s{seed}", d["samples"])
    if rows_from:
        merge_recorded_rows(rows, rows_from, row_stack(rows["reals_floor"]))
    for arm in ARMS[1:]:
        for seed in seeds:
            plain, other = rows.get(f"torch_s{seed}"), rows.get(f"{arm}_s{seed}")
            if plain and other:
                print(json.dumps({f"rel_gap_{arm}_vs_torch": rel_gaps(plain, other),
                                  "seed": seed}), flush=True)
    if pool:
        for arm in ARMS[1:]:
            stats = pooled_stats(rows, seeds, "torch", arm)
            if stats:
                print(json.dumps(stats), flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cmd", choices=["train", "evaluate"])
    p.add_argument("--config", default="mnist", choices=sorted(CONFIGS))
    p.add_argument("--examples", type=int, default=60_000)
    p.add_argument("--out", type=str, default="runs/quality")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="keep the generator-weight EMA and sample the eval set from the "
                        "averaged weights (torch_ema_*)")
    p.add_argument("--bf16", action="store_true",
                   help="both networks compute in bfloat16 (torch_bf16_*)")
    p.add_argument("--adaptive", action="store_true",
                   help="the closed-loop σ controller from the same σ₀ instead of the "
                        "open-loop schedule (torch_adaptive_*); the meta says how far it "
                        "trained")
    p.add_argument("--ref_grad_scale", action="store_true",
                   help="reference_grad_scale=True: the reference's ×B critic gradient "
                        "(torch_refscale_*)")
    p.add_argument("--gen_upsample", default="transpose", choices=["transpose", "resize"],
                   help="the generator's upsampling: 'resize' is nearest-2x + Conv "
                        "(torch_resize_*)")
    p.add_argument("--ttur_g_lr", type=float, default=0.0,
                   help="TTUR: the generator's own learning rate (torch_ttur_*)")
    p.add_argument("--d_steps", type=int, default=1,
                   help="critic steps per generator step (torch_d<N>_*)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--concurrent_runs", type=int, default=1,
                   help="how many runs share the device (recorded in the meta)")
    p.add_argument("--dir", type=str, default=None,
                   help="evaluate: where the sample sets are (default: --out)")
    p.add_argument("--seeds", type=str, default="0", help="evaluate: the seeds to score")
    p.add_argument("--inception", action=argparse.BooleanOptionalAction, default=True,
                   help="evaluate: the Inception FID column (on by default, as in the "
                        "recorded rows)")
    p.add_argument("--inception_size", type=int, default=75,
                   help="evaluate: the Inception trunk's input size")
    p.add_argument("--pool", action="store_true",
                   help="evaluate: the pooled statistics of each arm against the plain run")
    p.add_argument("--rows_from", type=str, default="",
                   help="evaluate: comma-separated JSONL files of earlier runs of the same "
                        "stack; their rows fill the sets absent here")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """``train``: the run's meta; ``evaluate``: the rows by name."""
    args = parse_args(argv)
    if args.cmd == "evaluate":
        return evaluate(CONFIGS[args.config], args.dir or args.out,
                        [int(x) for x in args.seeds.split(",") if x], device=args.device,
                        use_inception=args.inception, inception_size=args.inception_size,
                        pool=args.pool, rows_from=[f for f in args.rows_from.split(",") if f])
    return train(CONFIGS[args.config], args.examples, args.out, args.seed,
                 ema_decay=args.ema_decay, bf16=args.bf16, adaptive=args.adaptive,
                 ref_grad_scale=args.ref_grad_scale, gen_upsample=args.gen_upsample,
                 ttur_g_lr=args.ttur_g_lr, d_steps=args.d_steps, device=args.device,
                 concurrent_runs=args.concurrent_runs)


if __name__ == "__main__":
    main()
