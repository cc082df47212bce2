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

The client axis pads to the engine's target (repeats of the last client)
and, over a cohort mesh's data axis, the batch axis to a multiple of its
size (zero rows of zero weight); each client group's and data slice's
block is copied to its own device (one device is a grid of one).

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

from repro_torch.core.aggregate import (block_slices, round_up_multiple,
                                        split_blocks)
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
    """One cohort window's training batch.

    ``parts[g][d]`` is the (xb, yb) block of client group ``g`` and data
    slice ``d`` on its device: (K_g, T, B_d, ...) stacked client batches,
    the step axis zero-padded to the window's longest client, the client
    axis padded with repeats of the last client to the engine's target
    and, over a data axis, the batch axis padded with zero rows.  ``xb``
    and ``yb`` are the whole window when it lies on one device (else
    None); given alone, they are its one part.  ``mask`` (K, T) float32,
    on the host, masks the padded steps; ``steps`` are the real per-client
    step counts and ``uniform`` says whether every client runs exactly
    ``T`` steps.  ``ready`` lists the CUDA events that the copies to each
    card recorded, as (device, event) (None on the CPU).  ``bm`` (B_pad,)
    weighs the batch rows over a data axis (1 real, 0 padding; None: every
    row counts)."""

    xb: Optional[torch.Tensor]
    yb: Optional[torch.Tensor]
    mask: torch.Tensor
    steps: List[int]
    uniform: bool
    ready: Optional[list] = None
    parts: Optional[list] = None
    bm: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.parts is None:
            self.parts = [[(self.xb, self.yb)]]

    def placed(self) -> list:
        """The tensors on the devices."""
        return [t for group in self.parts for part in group for t in part]


class WindowAssembler:
    """Double-buffered host-side batch assembly for the cohort engine.

    ``assemble`` is the synchronous path: sample every client's batches,
    pad the step axis, stack, pad the client axis to the engine's target
    and the batch axis to a multiple of the data slices, and copy each
    block to its device of ``grid`` (the (C, D) devices of the engine's
    client groups and data slices; one device is ``[[device]]``), the
    reference's ``device_put`` with the engine's shardings.
    ``prefetch``/``take`` add the overlap: ``prefetch`` schedules the same
    assembly on the shared one-worker executor and ``take`` collects it,
    falling back to inline assembly whenever the prefetched request does
    not match, so correctness never depends on the caller prefetching the
    right thing.  ``overlap=False`` assembles every window inline; both
    modes give bit-identical windows.
    """

    def __init__(self, programs, grid, *, overlap: bool = True):
        self.programs = programs
        self.grid = np.asarray(grid, dtype=object)
        self.overlap = overlap
        self._streams = {}           # the copies' CUDA stream per device
        self._pending = None         # (key, Future[AssembledWindow])

    @staticmethod
    def _key(datasets, seeds, epochs: int, cohort_target):
        return (tuple(id(ds) for ds in datasets),
                tuple(int(s) for s in seeds), int(epochs), cohort_target)

    def _copy(self, t: torch.Tensor, dev, cards: list) -> torch.Tensor:
        """``t`` on ``dev``; to a card from pinned memory on the
        assembler's stream for that card, which joins ``cards``.  A block
        cut across the batch axis is made contiguous first (pinned, so its
        copy stays asynchronous)."""
        if not t.is_contiguous() or (dev.type == "cuda" and not t.is_pinned()):
            t = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=dev.type == "cuda").copy_(t)
        if dev.type != "cuda":
            return t.to(dev)
        with torch.cuda.device(dev):
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream()
            with torch.cuda.stream(self._streams[dev]):
                out = t.to(dev, non_blocking=True)
        if dev not in cards:
            cards.append(dev)
        return out

    def assemble(self, datasets: Sequence, seeds: Sequence[int],
                 epochs: int, cohort_target: Optional[int] = None
                 ) -> AssembledWindow:
        """Synchronous assembly (also what the background thread runs)."""
        batches = [self.programs.client_batches(ds, seed, epochs)
                   for ds, seed in zip(datasets, seeds)]
        steps = [int(xb.shape[0]) for xb, _ in batches]
        T = max(steps)
        n_groups, n_data = self.grid.shape
        cuda = any(d.type == "cuda" for d in self.grid.flat)
        # client-axis padding: repeats of the last client
        batches += [batches[-1]] * (max(cohort_target or 0, len(steps))
                                    - len(steps))
        # batch rows padded to a multiple of the data slices: zero rows of
        # zero weight, so they never enter the summed gradients
        b = batches[0][0].shape[1]
        bp = round_up_multiple(b, n_data)

        def stacked(arrays):
            out = torch.zeros((len(arrays), T, bp) + arrays[0].shape[2:],
                              dtype=torch.from_numpy(arrays[0][:0]).dtype,
                              pin_memory=cuda)
            for k, a in enumerate(arrays):
                out[k, :a.shape[0], :b] = torch.from_numpy(
                    np.ascontiguousarray(a))
            return out

        xb = stacked([x for x, _ in batches])
        yb = stacked([y for _, y in batches])
        mask = (torch.arange(T)[None, :]
                < torch.tensor(steps)[:, None]).float()
        uniform = all(s == T for s in steps)
        bm = (torch.arange(bp) < b).float() if n_data > 1 else None
        cards = []

        def copy(t, dev):
            return self._copy(t, dev, cards)

        parts = [list(zip(split_blocks(xb[rows], devices, 2, copy),
                          split_blocks(yb[rows], devices, 2, copy)))
                 for rows, devices in zip(block_slices(xb.shape[0], n_groups),
                                          self.grid)]
        ready = []
        for dev in cards:
            with torch.cuda.device(dev):
                event = torch.cuda.Event()
                event.record(self._streams[dev])
            ready.append((dev, event))
        xb, yb = parts[0][0] if self.grid.size == 1 else (None, None)
        return AssembledWindow(xb, yb, mask, steps, uniform, ready or None,
                               parts, bm)

    def prefetch(self, datasets: Sequence, seeds: Sequence[int],
                 epochs: int, cohort_target: Optional[int] = None) -> None:
        """Schedule background assembly of the given window (one slot: a
        second prefetch before the first is taken replaces it).  No-op when
        overlap is off."""
        if not self.overlap:
            return
        key = self._key(datasets, seeds, epochs, cohort_target)
        pending = self._pending
        if pending is not None and pending[0] == key:
            return                   # already in flight
        self._drain_pending()
        fut: Future = _shared_executor().submit(
            self.assemble, tuple(datasets), tuple(seeds), epochs,
            cohort_target)
        self._pending = (key, fut)

    def take(self, datasets: Sequence, seeds: Sequence[int], epochs: int,
             cohort_target: Optional[int] = None) -> AssembledWindow:
        """The prefetched window when it matches this request, else inline
        assembly (identical output either way), ready for use on the
        current stream of each device it lies on."""
        pending, self._pending = self._pending, None
        win = None
        if pending is not None:
            key, fut = pending
            win = fut.result()
            if key != self._key(datasets, seeds, epochs, cohort_target):
                win = None           # stale prefetch: settled, discarded
        if win is None:
            win = self.assemble(datasets, seeds, epochs, cohort_target)
        for dev, event in win.ready or ():
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            # allocated on the copy stream, used on the consumer's: the
            # allocator must not reuse them before the consumer is done
            for t in win.placed():
                if t.device == dev:
                    t.record_stream(consumer)
        return win

    def _drain_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending[1].result()      # never leave assembly racing the next

    def close(self) -> None:
        """Settle any in-flight assembly.  The worker thread is the shared
        executor's: nothing per assembler to tear down."""
        self._drain_pending()
