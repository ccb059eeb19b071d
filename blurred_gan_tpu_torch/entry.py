"""What the two training entry points (``train_celeba``, ``train_mnist``) share:
the flags both take, the set-up from parsed flags up to the dataset, the
``Trainer`` assembled around a dataset, networks and σ controller, their
metric feeders, and the run in the host loop or in chunks. Each entry point
keeps only its own dataset, networks and σ controller.

Under ``python -m torch.distributed.run --nproc_per_node N -m <entry point>``
the set-up starts the process group first (``runtime.py``; ``--dist_backend``
names its backend, else ``nccl`` on the card and ``gloo`` on the CPU), a bare
``--device cuda`` becomes ``cuda:<LOCAL_RANK>``, ``--batch_size`` is each
process's batch and the global batch is N times it.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
import torch.distributed as dist

from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.inception import inception_feature_fn
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.runtime import local_device, maybe_initialize_distributed
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters, TrainingConfig
from blurred_gan_tpu_torch.train.fast import chunk_plan
from blurred_gan_tpu_torch.train.loop import MetricFeeder, Trainer, TrainerConfig
from blurred_gan_tpu_torch.utils.rundir import create_result_subdir


def set_float32_precision() -> None:
    """True float32 everywhere: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_fields(device: torch.device) -> dict:
    """``device`` and ``power_limit_w`` of a run's record (the bench's line,
    a quality run's meta)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    name, limit = card_line().rsplit(",", 1)
    try:
        watts = float(limit.split()[0])
    except ValueError:  # "[N/A]"
        watts = None
    return {"device": name.strip(), "power_limit_w": watts}


def add_common_arguments(parser: argparse.ArgumentParser) -> None:
    """The hyper-parameters, the run configuration and the flags of both
    entry points."""
    BlurredWGANGPHyperParameters.add_arguments(parser)
    TrainingConfig.add_arguments(parser)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="cap the steps of this invocation")
    parser.add_argument("--adaptive", action="store_true",
                        help="closed-loop σ controller instead of the open-loop decay")
    parser.add_argument("--inception_fid", action="store_true",
                        help="score FID on the InceptionV3 pool3 trunk (local weights; "
                             "see metrics/inception.py)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_name", type=str, default=None,
                        help="create an auto-numbered results/NN-<name> run dir")
    parser.add_argument("--device_resident", action="store_true",
                        help="park the dataset on the card and run chunks of "
                             "--chunk_steps steps, each a replay of the captured train "
                             "step (SWD/FID measured at chunk boundaries)")
    parser.add_argument("--chunk_steps", type=int, default=100)
    parser.add_argument("--fetch_timeout_s", type=float, default=0.0,
                        help="device-hang watchdog: per-step budget (seconds) for the "
                             "metric fetch (chunked mode scales it by chunk_steps), "
                             "failing with DeviceHangError instead of hanging (0 = off; "
                             "resume from the latest checkpoint)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="backend of a multi-process run's group (default: nccl on "
                             "cuda, gloo on cpu)")


def setup_device(name: str) -> torch.device:
    """The ``--device`` of an entry point or tool: a missing card is refused,
    never replaced by the CPU; float32 precision is set."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA device")
    set_float32_precision()
    return device


def setup(args: argparse.Namespace):
    """(device, hparams, config) for parsed ``args``: the process group
    where the environment asks for one, this process's device
    (:func:`setup_device`), the global batch (``--batch_size`` times the
    processes) and the ``--run_name`` directory."""
    device = local_device(args.device)
    world = maybe_initialize_distributed(device, args.dist_backend)
    device = setup_device(device)
    hparams = BlurredWGANGPHyperParameters.from_args(args)
    hparams.global_batch_size = hparams.batch_size * world
    config = TrainingConfig.from_args(args)
    if args.run_name:
        config.log_dir = create_result_subdir("results", args.run_name)
        config.checkpoint_dir = ""
    return device, hparams, config


def make_trainer(args: argparse.Namespace, device, hparams, config, dataset, gan, *,
                 blur_controller, adaptive_controller, feeders: list,
                 **cadences) -> Trainer:
    """The ``Trainer`` of an entry point; ``cadences`` are further
    ``TrainerConfig`` fields."""
    return Trainer(
        gan, hparams, dataset, device=device,
        trainer_config=TrainerConfig(
            log_dir=config.log_dir,
            checkpoint_dir=config.checkpoint_dir,
            image_summaries_interval_batches=config.save_image_summaries_interval,
            device_fetch_timeout_s=args.fetch_timeout_s,
            seed=args.seed, **cadences),
        blur_controller=blur_controller, adaptive_controller=adaptive_controller,
        metric_feeders=feeders,
        config_sidecars={"hparams": hparams, "config": config})


def entry_point_feeders(inception_fid: bool, device) -> list:
    """SWD over 1000 samples and FID over 100, each every 50,000 examples."""
    fid = (FIDMetric(feature_fn=inception_feature_fn(device=device)) if inception_fid
           else FIDMetric())
    return [MetricFeeder(SWDMetric(), every_n_examples=50_000, num_samples=1000, name="swd"),
            MetricFeeder(fid, every_n_examples=50_000, num_samples=100, name="fid")]


def start_line(name: str, trainer: Trainer, **fields) -> None:
    """The entry point's start line, printed once (by rank 0): ``fields``,
    then the process count and the global batch."""
    if trainer.is_main:
        pairs = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[{name}] {pairs} processes={trainer.world} "
              f"global_bs={trainer.hparams.global_batch_size}", flush=True)


def shutdown() -> None:
    """End the process group, if one was started."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def run(trainer: Trainer, args: argparse.Namespace, total_examples: int, name: str) -> None:
    """``fit``, or with ``--device_resident`` ``fit_device_resident`` with
    ``--max_steps`` rounded up to whole chunks."""
    if not args.device_resident:
        trainer.fit(total_examples=total_examples, max_steps=args.max_steps)
        return
    chunk_steps, max_chunks, rounded = chunk_plan(args.chunk_steps, args.max_steps)
    if rounded:
        print(f"[{name}] --max_steps {args.max_steps} rounds up to "
              f"{max_chunks * chunk_steps} (whole chunks of {chunk_steps})", flush=True)
    trainer.fit_device_resident(total_examples=total_examples, chunk_steps=chunk_steps,
                                max_chunks=max_chunks)

