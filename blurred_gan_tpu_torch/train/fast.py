"""Device-resident chunked training (port of ``blurred_gan_tpu/train/fast.py``).

The host loop (``Trainer.fit``) launches each step's few hundred kernels from
Python, so its rate is whatever the host leaves. For a dataset that fits on
the card as uint8 (MNIST 45 MB, CelebA-128 ~9.5 GB of the H100's 80 GB) this
mode parks the whole store on the device once and runs ``chunk_steps`` steps
per chunk, each gathering its batch from the store by a ``(K, B)`` index
matrix copied to the card once per chunk.

On a CUDA device the whole train step (gather, σ, critic step with the
penalty's double backward, both optimizer updates, the generator's average,
the σ controller, the metrics row) is captured as a CUDA graph and each step
of a chunk replays it: the host only reseeds the step's generator and launches
the graph. A configuration whose steps differ by phase (lazy GP,
``d_steps_per_g_step``; ``train/step.py``) has one graph per phase it reaches,
at most four, each in its own memory pool; the host picks each step's graph
from its counter, which it knows for every step of a chunk. On the CPU
(tests) the same per-step function runs eagerly. Nothing falls back: on the
card a capture that fails raises.

The σ controllers run on the device, with no host sync:

- the open-loop decay as the closed form ``max(σ₀ · r^(n/decay_steps),
  min_value)`` of the device batch counter, in float64 and then rounded to
  float32, which is exactly the σ that ``Trainer.fit`` feeds from the host
  (the JAX package computes it in float32, an ulp away at some steps: enough,
  through Adam, to part two runs' losses by 1e-3 within a dozen steps);
- the adaptive controller as tensor ops on :class:`AdaptiveState`, the same
  transition as ``sched.blur.AdaptiveBlurController.update``.

Each step writes its scalars into row ``i`` of a ``(K, M)`` float32 buffer,
columns in ``sorted(metrics)`` order, which the host fetches once per chunk.

With the adaptive controller, once ``stop_training`` is raised inside a chunk
the chunk's remaining steps leave the state as it is (the host loop would
have stopped launching them, but the host has queued them before it can see
the flag): each step commits its parameters, BatchNorm statistics, optimizer
state, generator average, controller state and counter through
``torch.where(stop, before, after)`` and writes a row of zeros.

The step's draws are those of ``Trainer.fit``: before each step the host
reseeds ``state.rng`` from ``(seed, n_batches)``, and the generator is
registered with every graph, so a replay draws what the eager step draws for
the same seed. Before its capture the runner switches both Adams to
``capturable`` (``train/state.py``), which the capture needs.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from blurred_gan_tpu_torch.sched.blur import (
    AdaptiveBlurController, AdaptiveBlurState, BlurDecayController)
from blurred_gan_tpu_torch.train.state import GAN, TrainState, set_capturable
from blurred_gan_tpu_torch.train.step import (
    Phase, make_step_body, reachable_phases, step_phase, step_seed)

# Eager steps of each phase on a side stream before the captures (PyTorch's
# CUDA-graph notes: lazy initialisation, cuDNN's algorithm choice (bfloat16's
# too) and the optimizers' state happen there, so that no capture allocates
# state). Under ``--bf16`` each replay also casts the float32 weights anew, in
# the graph's pool.
WARMUP_STEPS = 3


class AdaptiveState(NamedTuple):
    """Device-side mirror of ``sched.blur.AdaptiveBlurState``: 0-d tensors."""

    std: torch.Tensor                      # float32
    score_ratio: torch.Tensor              # float32
    last_modification_batch: torch.Tensor  # int64
    stop_training: torch.Tensor            # bool

    @classmethod
    def from_host(cls, state: AdaptiveBlurState, device) -> "AdaptiveState":
        return cls(torch.tensor(state.std, dtype=torch.float32, device=device),
                   torch.tensor(state.score_ratio, dtype=torch.float32, device=device),
                   torch.tensor(state.last_modification_batch, dtype=torch.int64,
                                device=device),
                   torch.tensor(state.stop_training, dtype=torch.bool, device=device))

    def to_host(self) -> AdaptiveBlurState:
        return AdaptiveBlurState(std=float(self.std), score_ratio=float(self.score_ratio),
                                 last_modification_batch=int(self.last_modification_batch),
                                 stop_training=bool(self.stop_training))


def adaptive_update(controller: AdaptiveBlurController, ada: AdaptiveState,
                    batch: torch.Tensor, fake_scores: torch.Tensor,
                    real_scores: torch.Tensor) -> AdaptiveState:
    """``AdaptiveBlurController.update`` as tensor ops (``fast.py:55-74`` of
    the JAX package): ``batch`` is the post-step counter, the scores are the
    step's batch means."""
    c = controller
    denom = real_scores + fake_scores
    ratio = torch.where(denom == 0.0, torch.full_like(denom, 0.5), fake_scores / denom)
    smoothed = c.smoothing * ada.score_ratio + (1 - c.smoothing) * ratio
    warm = batch >= c.warmup_n_batches
    stable = (smoothed >= 0.5 - c.threshold) & (smoothed <= 0.5 + c.threshold)
    not_recent = batch - ada.last_modification_batch >= c.delay_between_modifications
    modify = warm & stable & not_recent
    std = torch.where(modify & c.apply_changes, c.smoothing * ada.std, ada.std)
    last_mod = torch.where(modify, batch, ada.last_modification_batch)
    stop = ada.stop_training | (std < c.min_value)
    return AdaptiveState(std, smoothed, last_mod, stop)


def decayed_sigma(controller: BlurDecayController, n_batches: torch.Tensor) -> torch.Tensor:
    """``BlurDecayController.sigma`` as the closed form of a device counter:
    the controller's float64 arithmetic, rounded to float32 as ``fit`` rounds
    the host's value."""
    s = controller.schedule
    sigma = s.initial_value * (s.decay_rate ** (n_batches.to(torch.float64) / s.decay_steps))
    return torch.clamp(sigma, min=controller.min_value).to(torch.float32)


def chunk_indices(num_examples: int, batch: int, chunk_steps: int,
                  start_batch_counter: int, seed: int) -> np.ndarray:
    """The index matrix of one chunk: the same epoch-seeded permutation
    stream as ``ArrayDataset.batches`` (resume-compatible). Each epoch's
    permutation is generated once, not per step."""
    if batch > num_examples:
        raise ValueError(f"global batch {batch} exceeds dataset size {num_examples}")
    steps_per_epoch = max(num_examples // batch, 1)
    out = np.empty((chunk_steps, batch), np.int32)
    perms = {}
    for i in range(chunk_steps):
        n = start_batch_counter + i
        epoch, pos = divmod(n, steps_per_epoch)
        if epoch not in perms:
            perms = {epoch: np.random.RandomState(seed + epoch).permutation(num_examples)}
        out[i] = perms[epoch][pos * batch:(pos + 1) * batch]
    return out


def chunk_plan(chunk_steps: int, max_steps: Optional[int]) -> Tuple[int, Optional[int], bool]:
    """``(chunk_steps, max_chunks, rounded)`` for an entry point's
    ``--max_steps``: the chunk shrinks to ``max_steps`` if that is smaller,
    and the chunk count rounds up so that at least ``max_steps`` run;
    ``rounded`` says that more than ``max_steps`` will."""
    if max_steps is None:
        return chunk_steps, None, False
    chunk_steps = min(chunk_steps, max_steps)
    max_chunks = -(-max_steps // chunk_steps)
    return chunk_steps, max_chunks, bool(max_steps % chunk_steps)


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step changes in place: both networks' parameters and
    buffers, both optimizers' state and the generator's average."""
    out = []
    for module in (state.generator, state.discriminator):
        out += list(module.parameters()) + list(module.buffers())
    for opt in (state.g_opt, state.d_opt):
        for slots in opt.state.values():
            out += [v for v in slots.values() if isinstance(v, torch.Tensor)]
    return out + list(state.g_ema or ())


class ChunkRunner:
    """Runs chunks of ``chunk_steps`` train steps on a device-resident copy of
    ``images`` (uint8 NHWC), updating ``state`` in place.

    ``run(idx, n_batches)`` takes the chunk's index matrix and the pre-chunk
    batch counter, queues the chunk and returns the ``(K, M)`` metrics buffer
    (columns ``self.names``); the caller advances ``state``'s host counters.
    ``adaptive`` holds the controller's state on the device between chunks.
    On a CUDA device the first ``run`` captures a graph for each phase in
    ``phases`` (``graphs``; ``capture_seconds``; ``capture_reserved``, the
    bytes the caching allocator held before the warm-up, after it with its
    cache emptied, and after the captures) and every step replays its
    phase's; ``fakes`` is the last step's critic-step fakes. The graphs write to the addresses of the state's
    tensors at their capture, all taken together: :meth:`reusable` says
    whether they still hold the state.
    """

    def __init__(self, gan: GAN, hparams, state: TrainState, images: np.ndarray,
                 chunk_steps: int, *, seed: int = 0,
                 blur_controller: Optional[BlurDecayController] = None,
                 adaptive_controller: Optional[AdaptiveBlurController] = None,
                 adaptive_state: Optional[AdaptiveBlurState] = None):
        if blur_controller is not None and adaptive_controller is not None:
            raise ValueError("at most one σ controller")
        self.state = state
        self.device = next(state.generator.parameters()).device
        self.images = images
        self.chunk_steps = chunk_steps
        self.seed = seed
        self.blur_controller = blur_controller
        self.adaptive_controller = adaptive_controller
        self.constant_sigma = float(getattr(hparams, "initial_blur_std", 0.0))
        self.hparams = hparams
        self.body = make_step_body(gan, hparams)
        self.phases = reachable_phases(hparams)
        self.data = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        batch = hparams.global_batch_size
        self.idx = torch.zeros((chunk_steps, batch), dtype=torch.int64, device=self.device)
        self.row = torch.zeros((), dtype=torch.int64, device=self.device)
        self.n_batches = torch.zeros((), dtype=torch.int64, device=self.device)
        self.adaptive = None
        if adaptive_controller is not None:
            self.adaptive = AdaptiveState.from_host(
                adaptive_state or adaptive_controller.init(), self.device)
        self.names: Optional[List[str]] = None
        self.out: Optional[torch.Tensor] = None
        self.fakes: Optional[torch.Tensor] = None
        self.graphs: Dict[Phase, torch.cuda.CUDAGraph] = {}
        self._graph_fakes: Dict[Phase, torch.Tensor] = {}
        self.capture_seconds = 0.0
        self.capture_reserved: Optional[Tuple[int, int, int]] = None
        self._captured: List[int] = []  # data_ptr of each state tensor at the captures

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The graph of the first phase (the full step, where the run takes
        one); None before the capture and on the CPU."""
        return self.graphs.get(self.phases[0])

    def reusable(self, images: np.ndarray, chunk_steps: int,
                 blur_controller: Optional[BlurDecayController],
                 adaptive_controller: Optional[AdaptiveBlurController]) -> bool:
        """Whether this runner can run chunks of ``chunk_steps`` on
        ``images`` with these controllers: the same objects, and (once
        captured) the state's tensors still where the graph writes. A restore
        or an optimizer switched back by ``fit`` moves them."""
        return (images is self.images and chunk_steps == self.chunk_steps
                and blur_controller is self.blur_controller
                and adaptive_controller is self.adaptive_controller
                and (not self.graphs
                     or [t.data_ptr() for t in state_tensors(self.state)] == self._captured))

    @torch.no_grad()
    def load_adaptive(self, state: AdaptiveBlurState) -> None:
        """Set the device controller state to the host's ``state``, in place."""
        for t, v in zip(self.adaptive, AdaptiveState.from_host(state, self.device)):
            t.copy_(v)

    def _sigma(self) -> torch.Tensor:
        if self.adaptive is not None:
            return self.adaptive.std
        if self.blur_controller is not None:
            return decayed_sigma(self.blur_controller, self.n_batches)
        return torch.full((), self.constant_sigma, dtype=torch.float32, device=self.device)

    def _step(self, phase: Phase) -> torch.Tensor:
        """One step of ``phase``, row ``self.row`` of the chunk. Launches only
        device work."""
        reals = self.data.index_select(0, self.idx.index_select(0, self.row.reshape(1))[0])
        sigma = self._sigma()
        gated = self.adaptive is not None
        if gated:
            with torch.no_grad():
                frozen = self.adaptive.stop_training.clone()
                before = {id(t): t.clone() for t in state_tensors(self.state)}
        metrics, fakes = self.body(self.state, reals, sigma, do_gp=phase[0], do_gen=phase[1])
        n_next = self.n_batches + 1
        if gated:
            ada = adaptive_update(self.adaptive_controller, self.adaptive, n_next,
                                  metrics["fake_scores"], metrics["real_scores"])
            metrics["blur_controller/std"] = ada.std
            metrics["blur_controller/smoothed_ratio"] = ada.score_ratio
            metrics["stop_training"] = ada.stop_training
        names = sorted(metrics)
        packed = torch.stack([metrics[k].to(torch.float32) for k in names])
        with torch.no_grad():
            if gated:
                for t in state_tensors(self.state):
                    # Optimizer state this step created is zeroed, which is
                    # what a fresh state is.
                    old = before.get(id(t))
                    torch.where(frozen, torch.zeros_like(t) if old is None else old, t, out=t)
                packed = torch.where(frozen, torch.zeros_like(packed), packed)
                n_next = torch.where(frozen, self.n_batches, n_next)
                for t, new in zip(self.adaptive, ada):
                    t.copy_(torch.where(frozen, t, new))
            if self.out is None:  # the first step, always eager
                self.names = names
                self.out = torch.zeros((self.chunk_steps, len(names)), dtype=torch.float32,
                                       device=self.device)
            self.out.index_copy_(0, self.row.reshape(1), packed[None])
            self.n_batches.copy_(n_next)
            self.row.add_(1)
        return fakes

    def _persistent(self) -> List[torch.Tensor]:
        runner = [self.row, self.n_batches, *(self.adaptive or ())]
        return state_tensors(self.state) + runner + ([self.out] if self.out is not None else [])

    def _capture(self) -> None:
        """Warm every phase up on a side stream, capture one graph per phase,
        then put back every tensor the warm-up changed (in place: the graphs
        hold their addresses). Optimizer state the warm-up created is zeroed,
        which is what a fresh Adam or RMSprop state is. Each graph has its own
        memory pool: a phase's ``fakes`` stay valid while another phase's
        graph replays."""
        t0 = time.perf_counter()
        set_capturable(self.state.g_opt, True)
        set_capturable(self.state.d_opt, True)
        reserved = [torch.cuda.memory_reserved(self.device)]
        # Without grad: a clone that tracked grad would keep each parameter's
        # gradient accumulator alive, bound to this (the default) stream, and
        # the captured backward would then have to sync with the default
        # stream, which a capture cannot.
        with torch.no_grad():
            saved = {id(t): t.clone() for t in self._persistent()}
        n0 = int(self.n_batches)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for i in range(WARMUP_STEPS):
                for phase in self.phases:
                    self.row.zero_()
                    self.state.rng.manual_seed(step_seed(self.seed, n0 + i))
                    self._step(phase)
        torch.cuda.current_stream(self.device).wait_stream(side)
        # The capture empties the allocator's cache on entry; emptied here
        # first, the reading after the captures is the graphs' pools.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(self.device))
        for phase in self.phases:
            graph = torch.cuda.CUDAGraph()
            # The step's latents, dropout masks, GP α and flips come from
            # state.rng: the graph reads its seed and offset at each replay.
            graph.register_generator_state(self.state.rng)
            self.row.zero_()
            self.state.rng.manual_seed(step_seed(self.seed, n0))
            # On the warm-up's stream, so that autograd state the warm-up left
            # behind needs no sync with another stream.
            with torch.cuda.graph(graph, stream=side):
                self._graph_fakes[phase] = self._step(phase)
            self.graphs[phase] = graph
        with torch.no_grad():
            for t in self._persistent():
                if id(t) in saved:
                    t.copy_(saved[id(t)])
                else:
                    t.zero_()
        torch.cuda.synchronize(self.device)
        reserved.append(torch.cuda.memory_reserved(self.device))
        self.capture_reserved = tuple(reserved)
        self._captured = [t.data_ptr() for t in state_tensors(self.state)]
        self.capture_seconds = time.perf_counter() - t0

    def run(self, idx: np.ndarray, n_batches: int) -> torch.Tensor:
        """Queue one chunk: ``idx`` is its ``(K, B)`` index matrix and
        ``n_batches`` the batch counter before it. Returns the metrics buffer."""
        self.idx.copy_(torch.from_numpy(idx))
        self.row.zero_()
        self.n_batches.fill_(n_batches)
        if self.device.type == "cuda" and not self.graphs:
            self._capture()
        for i in range(self.chunk_steps):
            phase = step_phase(self.hparams, n_batches + i)
            self.state.rng.manual_seed(step_seed(self.seed, n_batches + i))
            if self.graphs:
                self.graphs[phase].replay()
                self.fakes = self._graph_fakes[phase]
            else:
                self.fakes = self._step(phase)
        return self.out
