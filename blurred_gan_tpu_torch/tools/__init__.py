"""Post-training command-line tools of the port (``python -m
blurred_gan_tpu_torch.tools.<name>``): ``export_generator`` (a serving
artifact from a run's checkpoint), ``evaluate_run`` (SWD and FID of a run's
latest checkpoint), ``score`` (SWD, FID, PRDC and KID between two sample
sets) and ``make_shards`` (an image folder or mnist.npz into a shard store)."""
