"""Host-side data pipelines: token-batch sampling and cohort-window assembly.

Port of ``repro.data.pipeline``.  :class:`TokenPipeline` is the LM
streaming sampler (synthetic Markov streams, optional disjoint per-client
sharding): the same windows as the reference's from the same seed.

:class:`WindowAssembler` is the cohort engine's host-side stage.  While
the card computes one cohort window, the NEXT window's batches are
sampled, stacked, padded and copied to the card on a background thread.
RNG parity is by construction: every client's batches come from
``np.random.default_rng(seed)`` seeded per client
(``programs.client_batches``), so the sampled images and tokens are
identical whether assembly runs inline, early or on another thread.

Padding follows the window, not a compile cache: the step axis is padded to
the window's own longest client (the reference keeps a monotone target,
and pads the client axis to a power of two, to bound XLA's compiled
programs; the port compiles nothing, so it keeps neither, and has no
``register_shards`` to pre-size them).

On the card the copies run on the assembler's own CUDA stream, from pinned
host memory, so they overlap training on the consumer's stream instead of
queueing behind it.  :meth:`WindowAssembler.take` makes the consumer's
stream wait for the copy's event and marks the tensors as used on that
stream, so the caching allocator cannot hand their memory out early.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.synthetic import make_lm_dataset


class TokenPipeline:
    """Infinite (batch, seq+1) sampler over a token stream with optional
    per-client sharding (each client sees a disjoint slice).

    Shard boundaries follow ``np.array_split``: the remainder tokens of
    ``len(stream) % n_shards`` spread over the first shards, so every
    token belongs to exactly one client."""

    def __init__(self, vocab: int, batch: int, seq: int,
                 n_tokens: int = 500_000, seed: int = 0,
                 n_shards: int = 1, shard: int = 0):
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} out of range for "
                             f"{n_shards} shards")
        stream = make_lm_dataset(vocab=vocab, n_tokens=n_tokens, seed=seed)
        self.stream = np.array_split(stream, n_shards)[shard]
        # a (seq+1)-token window needs at least one valid start position
        if len(self.stream) < seq + 1:
            raise ValueError(
                f"shard {shard} holds {len(self.stream)} tokens but "
                f"seq={seq} windows need at least {seq + 1}; lower "
                f"n_shards (={n_shards}) or raise n_tokens (={n_tokens})")
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed * 997 + shard)

    def __iter__(self) -> Iterator[np.ndarray]:
        # starts range over every valid window, so the shard's final token
        # is reachable (high is exclusive: max start = len - seq - 1)
        while True:
            starts = self.rng.integers(
                0, len(self.stream) - self.seq, self.batch)
            yield np.stack([self.stream[s:s + self.seq + 1] for s in starts])

    def batch_dict(self, arr: np.ndarray):
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}


_SHARED_EXECUTOR: Optional[ThreadPoolExecutor] = None
_SHARED_EXECUTOR_LOCK = threading.Lock()


def _shared_executor() -> ThreadPoolExecutor:
    """One process-wide assembly worker, created on first use: a sweep that
    builds many engines must not accumulate one idle thread per engine, and
    the one-slot prefetch protocol never has more than one window in flight
    anyway."""
    global _SHARED_EXECUTOR
    with _SHARED_EXECUTOR_LOCK:
        if _SHARED_EXECUTOR is None:
            _SHARED_EXECUTOR = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="window-assembler")
        return _SHARED_EXECUTOR


@dataclass
class AssembledWindow:
    """One cohort window's training batch on the engine's device.

    ``xb``/``yb`` are (K, T, B, ...) stacked client batches, the step axis
    zero-padded to the window's longest client; ``mask`` (K, T) float32, on
    the host, masks the padded steps; ``steps`` are the real per-client step
    counts and ``uniform`` says whether every client runs exactly ``T``
    steps.  ``ready`` is the CUDA event that the copies to the card
    recorded (None on the CPU)."""

    xb: torch.Tensor
    yb: torch.Tensor
    mask: torch.Tensor
    steps: List[int]
    uniform: bool
    ready: Optional[torch.cuda.Event] = None


class WindowAssembler:
    """Double-buffered host-side batch assembly for the cohort engine.

    ``assemble`` is the synchronous path: sample every client's batches,
    pad the step axis, stack, and copy to ``device``.  ``prefetch``/``take``
    add the overlap: ``prefetch`` schedules the same assembly on the shared
    one-worker executor and ``take`` collects it, falling back to inline
    assembly whenever the prefetched request does not match, so correctness
    never depends on the caller prefetching the right thing.
    ``overlap=False`` assembles every window inline; both modes give
    bit-identical windows.
    """

    def __init__(self, programs, device, *, overlap: bool = True):
        self.programs = programs
        self.device = torch.device(device)
        self.overlap = overlap
        self._stream = None          # the copies' CUDA stream, made lazily
        self._pending = None         # (key, Future[AssembledWindow])

    @staticmethod
    def _key(datasets, seeds, epochs: int):
        return (tuple(id(ds) for ds in datasets),
                tuple(int(s) for s in seeds), int(epochs))

    def assemble(self, datasets: Sequence, seeds: Sequence[int],
                 epochs: int) -> AssembledWindow:
        """Synchronous assembly (also what the background thread runs)."""
        batches = [self.programs.client_batches(ds, seed, epochs)
                   for ds, seed in zip(datasets, seeds)]
        steps = [int(xb.shape[0]) for xb, _ in batches]
        T = max(steps)
        cuda = self.device.type == "cuda"

        def stacked(arrays):
            out = torch.zeros((len(arrays), T) + arrays[0].shape[1:],
                              dtype=torch.from_numpy(arrays[0][:0]).dtype,
                              pin_memory=cuda)
            for k, a in enumerate(arrays):
                out[k, :a.shape[0]] = torch.from_numpy(np.ascontiguousarray(a))
            return out

        xb = stacked([x for x, _ in batches])
        yb = stacked([y for _, y in batches])
        mask = (torch.arange(T)[None, :]
                < torch.tensor(steps)[:, None]).float()
        uniform = all(s == T for s in steps)
        ready = None
        if cuda:
            with torch.cuda.device(self.device):
                if self._stream is None:
                    self._stream = torch.cuda.Stream()
                with torch.cuda.stream(self._stream):
                    xb = xb.to(self.device, non_blocking=True)
                    yb = yb.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
        else:
            xb, yb = xb.to(self.device), yb.to(self.device)
        return AssembledWindow(xb, yb, mask, steps, uniform, ready)

    def prefetch(self, datasets: Sequence, seeds: Sequence[int],
                 epochs: int) -> None:
        """Schedule background assembly of the given window (one slot: a
        second prefetch before the first is taken replaces it).  No-op when
        overlap is off."""
        if not self.overlap:
            return
        key = self._key(datasets, seeds, epochs)
        pending = self._pending
        if pending is not None and pending[0] == key:
            return                   # already in flight
        self._drain_pending()
        fut: Future = _shared_executor().submit(
            self.assemble, tuple(datasets), tuple(seeds), epochs)
        self._pending = (key, fut)

    def take(self, datasets: Sequence, seeds: Sequence[int],
             epochs: int) -> AssembledWindow:
        """The prefetched window when it matches this request, else inline
        assembly (identical output either way), ready for use on the
        caller's current stream."""
        pending, self._pending = self._pending, None
        win = None
        if pending is not None:
            key, fut = pending
            win = fut.result()
            if key != self._key(datasets, seeds, epochs):
                win = None           # stale prefetch: settled, discarded
        if win is None:
            win = self.assemble(datasets, seeds, epochs)
        if win.ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(win.ready)
            # allocated on the copy stream, used on the consumer's: the
            # allocator must not reuse them before the consumer is done
            win.xb.record_stream(consumer)
            win.yb.record_stream(consumer)
        return win

    def _drain_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending[1].result()      # never leave assembly racing the next

    def close(self) -> None:
        """Settle any in-flight assembly.  The worker thread is the shared
        executor's: nothing per assembler to tear down."""
        self._drain_pending()
