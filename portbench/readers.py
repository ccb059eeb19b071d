"""What the per-layer metrics compute, one function a quantity. Each file
``metrics/<metric>.py`` names the function it reads with (``read``), so two
cells that report a quantity under names of their own share its arithmetic.
A function returns None where the run holds nothing to read; never 0 for a
share of a roofline or a peak."""

from __future__ import annotations

# PyTorch's copy kernels (every ``.to`` and ``.contiguous``), cuDNN's layout
# transposes and the runtime's copies, matched as written here.
COPY_PATTERNS = ("copy_kernel", "nchwToNhwc", "nhwcToNchw", "Memcpy")
BLUR_KERNELS = ("blur_sigma_kernel", "blur_planes_kernel")


def device_idle(r):
    """The share of the window, in %, in which no kernel and no copy ran on
    the card."""
    lo, hi = r.trace.window()
    if hi <= lo:
        return None
    return 100.0 * (1.0 - r.trace.busy_ns() / (hi - lo))


def chunk_gap_ms(r):
    """Device idle time at a chunk boundary, in ms, averaged over the
    window's boundaries: from the end of a chunk's last operation, the copy
    of its metrics to the host (the only device-to-host copy of the chunked
    mode), to the next chunk's first operation."""
    ops = r.trace.window_ops()
    fetches = [i for i, (name, _, _) in enumerate(ops) if "Memcpy DtoH" in name]
    gaps = [ops[i + 1][1] - ops[i][2] for i in fetches if i + 1 < len(ops)]
    if not gaps:
        return None
    return sum(max(g, 0) for g in gaps) / len(gaps) / 1e6


def copy_share(r):
    """Device time in copies, dtype casts and NCHW<->NHWC transposes, in % of
    the device's operation time in the window."""
    ops = r.trace.window_ops()
    total = sum(e - s for _, s, e in ops)
    if total <= 0:
        return None
    copies = sum(e - s for n, s, e in ops if any(p in n for p in COPY_PATTERNS))
    return 100.0 * copies / total


def blur_roofline(r):
    """The blur kernel's share of its roofline: the least time the window's
    blur work could take on the card (the larger of its bytes, each float32
    plane read once and written once, over HBM's rate, and its taps' FLOPs
    over the float32 peak; the work counted from the configuration's blur
    applications a step, ``portbench/flops.py``), over the blur kernels'
    device time."""
    hbm, fp32 = r.peak("hbm_bytes"), r.peak("float32")
    kernel_ns = sum(e - s for n, s, e in r.trace.window_ops()
                    if any(k in n for k in BLUR_KERNELS))
    if hbm is None or fp32 is None or kernel_ns <= 0:
        return None
    least = max(r.facts["blur_bytes_per_step"] / hbm, r.facts["blur_flops_per_step"] / fp32)
    return 100.0 * least * r.facts["steps"] / (kernel_ns / 1e9)


def mfu_step(r):
    """The train step's share of the card's dense peak for the
    configuration's compute dtype: its FLOPs a step (``portbench/flops.py``)
    times the traced window's steps, over the window, over the peak."""
    p = r.peak(r.config["compute_dtype"])
    lo, hi = r.trace.window()
    if p is None or hi <= lo:
        return None
    return 100.0 * r.facts["step_flops"] * r.facts["steps"] / ((hi - lo) / 1e9) / p


def mfu_sample(r):
    """The generator forward's share of the card's dense peak for the
    configuration's compute dtype: its FLOPs an image times the window's
    images, over the window, over the peak."""
    p = r.peak(r.config["compute_dtype"])
    lo, hi = r.trace.window()
    if p is None or hi <= lo:
        return None
    return 100.0 * r.facts["generator_flops_per_image"] * r.facts["images"] / ((hi - lo) / 1e9) / p
