"""The plain reference of the benchmark's configurations: float32 PyTorch,
no kernels, no graphs, no batching tricks.

It is written from the configurations' published description (the DCGAN
pairs of the blurred-GAN demos, the separable Gaussian blur with its
kernel-size policy, the WGAN-GP losses with drift, Adam) and imports nothing
of the program under test. ``precision`` rounds the operands of every
product for the controls (a lower precision than the configuration states).
"""
