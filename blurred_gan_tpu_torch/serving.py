"""Serving export: a trained generator frozen into a ``torch.export`` artifact
that runs without this package or the checkpoint (port of
``blurred_gan_tpu/serving.py``, which writes a StableHLO artifact).

The artifact is the bytes of ``torch.export.save``: the eval-mode generator
as an ATen graph with its weights and running BatchNorm statistics stored in
it, and a dynamic batch dimension, so one artifact serves any batch ≥ 1::

    from blurred_gan_tpu_torch.serving import export_generator, load_generator
    blob = export_generator(gan, state)            # bytes
    serve = load_generator(blob)                   # callable
    images = serve(latents)                        # (B, latent) -> (B, C, H, W)

A consumer needs only torch::

    program = torch.export.load("generator.pt2")
    images = program.module()(latents)

An artifact holds its tensors on the device it was exported from (the JAX
package's ``platforms`` argument becomes ``device``). To serve it on another
device, move it with ``torch.export.passes.move_to_device_pass``
(``load_generator(..., device=...)`` does).

The program runs in its consumer's precision settings. cuDNN's default lets
convolutions use TF32, so a process that has not set
``torch.backends.cudnn.allow_tf32 = False`` (as the port's entry points and
tools do, ``entry.set_float32_precision``) serves other numbers than the
float32 the port trains and checks in.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Callable

import torch
from torch.export import Dim

# The batch of the example input: torch.export specialises a dimension it
# sees at 0 or 1, so the trace runs at 2 and batch 1 is served by the
# dynamic dimension's lower bound.
EXAMPLE_BATCH = 2


def export_generator(gan, state, *, use_ema: bool = False, device=None,
                     batch_dim: str = "b") -> bytes:
    """The bytes of a ``torch.export`` program ``z -> images`` with the
    generator's weights and running BatchNorm statistics baked in.

    - ``use_ema``: bake the average ``state.g_ema`` with the live BatchNorm
      statistics (as ``make_sample_fn(use_ema=True)`` samples) instead of the
      live weights; the state must keep one (``ema_decay > 0``).
    - ``device``: the artifact's device (default: the generator's).
    - ``batch_dim``: the name of the dynamic batch dimension; the program
      takes ``(B, latent_size)`` float32 latents for any B ≥ 1.
    """
    if use_ema and not state.g_ema:
        raise ValueError("use_ema=True but the state has no EMA weights "
                         "(train with ema_decay > 0)")
    module = copy.deepcopy(state.generator)
    if use_ema:
        with torch.no_grad():
            for p, e in zip(module.parameters(), state.g_ema):
                p.copy_(e)
    if device is not None:
        module.to(device)
    module.eval().requires_grad_(False)
    example = torch.zeros((EXAMPLE_BATCH, gan.latent_size),
                          device=next(module.parameters()).device)
    program = torch.export.export(module, (example,),
                                  dynamic_shapes=({0: Dim(batch_dim, min=1)},))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_generator(blob_or_path, device=None) -> Callable:
    """``serve(latents) -> images`` from an artifact's bytes or path.

    ``device``: move the program there first (default: where it was
    exported). ``serve`` takes ``(B, latent_size)`` latents (a tensor or an
    array, any B ≥ 1) and returns NCHW float32 images on the program's
    device, without autograd. ``serve.exported`` is the ``ExportedProgram``.
    """
    if isinstance(blob_or_path, (str, os.PathLike)):
        program = torch.export.load(blob_or_path)
    else:
        program = torch.export.load(io.BytesIO(bytes(blob_or_path)))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    module = program.module()
    target = next(iter(program.state_dict.values())).device

    @torch.no_grad()
    def serve(latents):
        return module(torch.as_tensor(latents, dtype=torch.float32, device=target))

    serve.exported = program
    return serve
