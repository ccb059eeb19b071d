"""Post-training command-line tools of the port (``python -m
blurred_gan_tpu_torch.tools.<name>``): ``export_generator`` (a serving
artifact from a run's checkpoint), ``evaluate_run`` (SWD and FID of a run's
latest checkpoint), ``score`` (SWD, FID, PRDC and KID between two sample
sets), ``make_shards`` (an image folder or mnist.npz into a shard store),
``diagnose_samples`` (pixel statistics, spectrum bands and the blurred
objective of sample sets), ``bn_stats_ab`` (a run's generator sampled with
running and with batch BatchNorm statistics) and ``convert_inception``
(InceptionV3 weights into the npz layout the FID trunk reads)."""
