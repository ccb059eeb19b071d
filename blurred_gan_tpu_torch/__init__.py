"""blurred_gan_tpu_torch — the PyTorch / CUDA port of ``blurred_gan_tpu``.

The CelebA-128 blurred WGAN-GP training path on an NVIDIA GPU (Hopper), beside
the JAX package that stays the reference. Images are NCHW. The one kernel the
JAX package wrote in Pallas, the fused separable blur, is a hand-written CUDA
kernel here (``ops/blur_cuda.py``, ``csrc/blur_planes.cu``). This package
imports torch and never jax, and nothing of the JAX package: what it needs of
that package's numpy-only modules it keeps as its own copies.

- ``data.pipeline``    numpy batch stream, synthetic corpus, shard store, image folders
- ``native``           the host JPEG / PNG decoder (C++, ctypes, built by g++)
- ``sched.blur``       the open-loop σ decay and the adaptive σ controller
- ``ops.blur``         blur sizing policy, band matrices, ``blur_images``
- ``ops.blur_cuda``    the kernel's build, wrapper and autograd Function
- ``models``           DCGAN generator / critic, the ``GaussianBlur`` layer
- ``losses.wgan``      WGAN-GP losses and the gradient penalty
- ``train``            hyperparameters, GAN / TrainState, the step, hooks,
                       checkpoints, ``Trainer`` (fit, evaluate, export)
- ``metrics``          SWD, FID, the InceptionV3 trunk
- ``utils``            config flags, images and PNGs, logging, run dirs, watchdog
- ``convert``          the JAX package's weights into the port's modules
- ``train_celeba``     the command-line entry point
"""
