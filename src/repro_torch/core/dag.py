"""The DAG ledger (IOTA-style tangle) that DAG-AFL coordinates over.

PyTorch port of ``repro.core.dag``: the ledger is framework-free and is
copied as it is, so hashes, tips and reachability agree with the reference
on the same operation sequence.  Only :class:`ModelStore` differs: it
counts the bytes of a model tree of torch tensors, and it can keep its
models on a device of its own (host memory) and copy them to the reader's.

Transactions carry ONLY metadata (paper §III-A: ``<ClientId, Signature,
ModelAccuracy, CurrentEpoch, ValidationNodeId>``); model weights travel peer
to peer through :class:`ModelStore`.  Tips are transactions with in-degree 0
(no later transaction approves them).  Each new transaction approves
``n_parents`` tips (2 in the paper).

Reachability (paper Alg. 1): BFS over *approval children* starting from the
client's own latest transaction — a tip is *reachable* iff it (directly or
transitively) approved the client's node, i.e. it has integrated the client's
previous aggregate.

Two ledger implementations share the :class:`LedgerView` protocol:

* :class:`DAGLedger` — the append-only reference ledger; every transaction
  ever published stays resident.
* :class:`BoundedDAGLedger` — the production ledger for 10^5-10^6 client
  populations.  When every current tip transitively approves a transaction
  it is *confirmed*; confirmed ancestry is periodically folded into a
  :class:`CheckpointRecord` (a merkle-style rollup of the pruned region's
  Eq. 7 hashes) and its bodies evicted, so live state is bounded by the
  consensus frontier, not total history.  Tip selection is index-backed:
  a freshness-ordered tip heap and incremental per-client reachability
  summaries replace from-scratch BFS + full tip scans.  See DESIGN.md.

Consumers (tip selection, verification, the coordinator) must go through
:class:`LedgerView` methods — ``get_tx``/``has_tx``/``hash_of``/... — never
the private ``_nodes``/``_children`` dicts, so ledger internals can change
without touching them.
"""
from __future__ import annotations

import hashlib
import heapq
import json
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Protocol, Sequence, Tuple, runtime_checkable)

import torch

from repro_torch.core.aggregate import (leaf_mean, tree_leaves, tree_map,
                                        tree_mean, tree_size_bytes)


@dataclass(frozen=True)
class TxMetadata:
    """Exactly the tuple the paper puts on chain (§III-B end)."""

    client_id: int
    signature: Tuple[float, ...]       # feature signature vector (Eq. 3-4)
    model_accuracy: float
    current_epoch: int                 # trainer's global iteration epoch
    validation_node_id: int

    def digest(self) -> str:
        payload = json.dumps({
            "client_id": self.client_id,
            "signature": [round(float(s), 8) for s in self.signature],
            "model_accuracy": round(float(self.model_accuracy), 8),
            "current_epoch": int(self.current_epoch),
            "validation_node_id": int(self.validation_node_id),
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()


@dataclass
class Transaction:
    tx_id: str
    metadata: TxMetadata
    parents: Tuple[str, ...]           # approved tips (empty for genesis)
    timestamp: float                   # simulated publish time
    tx_hash: str = ""                  # Eq. 7: H(H1 | H2 | hash(metadata))
    model_ref: str = ""                # ModelStore key (P2P pointer)
    seq: int = 0                       # global append order (audit cursor)


def compute_tx_hash_from_digest(parent_hashes: Sequence[str],
                                metadata_digest: str) -> str:
    """Eq. 7 from an already-computed metadata digest (used when the body
    has been pruned and only the digest survives in a validation path)."""
    h = hashlib.sha256()
    for ph in parent_hashes:
        h.update(ph.encode())
    h.update(metadata_digest.encode())
    return h.hexdigest()


def compute_tx_hash(parent_hashes: Sequence[str], metadata: TxMetadata) -> str:
    """Eq. 7: block header = parent hashes, body = metadata digest."""
    return compute_tx_hash_from_digest(parent_hashes, metadata.digest())


def checkpoint_root(prev_root: str, leaves: Sequence[Tuple[str, str]]) -> str:
    """Merkle-style rollup of a pruned region: chain the previous
    checkpoint's root with the sorted ``(tx_id, tx_hash)`` leaves."""
    h = hashlib.sha256()
    h.update(prev_root.encode())
    for tx_id, tx_hash in sorted(leaves):
        h.update(tx_id.encode())
        h.update(tx_hash.encode())
    return h.hexdigest()


@dataclass(frozen=True)
class CheckpointRecord:
    """One checkpoint+prune: the confirmed region folded into a rollup.

    ``leaf_ids`` names the pruned transactions; their Eq. 7 hashes stay
    resident in the ledger's retained-hash map so ``root`` can be
    re-derived (tamper audit) and validation paths that cross the pruned
    region can still be hash-checked without the bodies.
    """

    ckpt_id: str
    seq: int                          # checkpoint ordinal (0-based)
    created_at: float                 # simulated time of the fold
    n_pruned: int                     # transactions folded by THIS record
    root: str                         # checkpoint_root(prev_root, leaves)
    prev_root: str
    leaf_ids: Tuple[str, ...]


GENESIS_ROOT = hashlib.sha256(b"dag-afl-checkpoint-genesis").hexdigest()


@runtime_checkable
class LedgerView(Protocol):
    """What ledger consumers (tip selection, verification, coordinator) may
    rely on.  Implemented by :class:`DAGLedger` and
    :class:`BoundedDAGLedger`; internals (``_nodes``/``_children`` dicts,
    indexes, prune bookkeeping) are private to the implementations.
    """

    genesis_id: Optional[str]

    def tips(self) -> List[str]: ...

    def tips_by_freshness(self, limit: Optional[int] = None) -> List[str]: ...

    def latest_of(self, client_id: int) -> Optional[str]: ...

    def head_seq(self) -> int: ...

    def reachable_tips(self, start_node: Optional[str],
                       within: Optional[Iterable[str]] = None
                       ) -> Tuple[List[str], List[str]]: ...

    def ancestors(self, tx_id: str,
                  max_depth: Optional[int] = None) -> List[str]: ...

    def get_tx(self, tx_id: str) -> Transaction: ...

    def has_tx(self, tx_id: str) -> bool: ...

    def is_pruned(self, tx_id: str) -> bool: ...

    def hash_of(self, tx_id: str) -> str: ...

    def transactions(self) -> Iterator[Transaction]: ...

    @property
    def checkpoints(self) -> Sequence[CheckpointRecord]: ...

    def __len__(self) -> int: ...


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device``; a card without an index is the
    current card, so that tensors on it compare equal to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class PinnedStaging:
    """Tensor copies between host memory and a card through two fixed
    pinned buffers of ``chunk_bytes`` a card: the card's copy engine fills
    or drains one buffer while the host copies the other to or from the
    pageable tensor (``copy_`` on the host runs on torch's intra-op
    threads).  On an H100's host (``chip_probes.py store``) this moved a
    14.7 GB model to the card 4-6x faster than ``Tensor.to`` from pageable
    memory, and to the host 1.5-2x faster, where page faults in the fresh
    host tensor bound both.  A pinned copy of every stored model would pin
    tens of GB of the host's memory and pays the same faults when it is
    made.  Any other pair of devices copies directly; a copy to the
    tensor's own device is a clone.  The card's copies run on its current
    stream, so the work queued there before and after stays ordered
    around them.  Each card has buffers and events of its own, so a copy
    queued to one card never reads a buffer that a copy to another is
    refilling."""

    def __init__(self, chunk_bytes: int = 1 << 25):
        self.chunk_bytes = chunk_bytes
        self._staged: Dict[torch.device, Tuple[List, List]] = {}

    def copy(self, t: torch.Tensor, device) -> torch.Tensor:
        device = _indexed(device)
        if t.device == device:
            return t.clone()
        if {t.device.type, device.type} != {"cpu", "cuda"} or t.numel() == 0:
            return t.to(device)
        card = device if device.type == "cuda" else t.device
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        src = t.contiguous().view(-1).view(torch.uint8)
        dst = out.view(-1).view(torch.uint8)
        with torch.cuda.device(card):
            buffers, events = self._card(card)
            if device.type == "cpu":
                self._to_host(src, dst, buffers, events)
            else:
                self._to_card(src, dst, buffers, events)
        return out

    def _card(self, card: torch.device) -> Tuple[List, List]:
        """The card's two pinned buffers and their events, made at its
        first copy."""
        if card not in self._staged:
            self._staged[card] = (
                [torch.empty(self.chunk_bytes, dtype=torch.uint8,
                             pin_memory=True) for _ in range(2)],
                [torch.cuda.Event() for _ in range(2)])
        return self._staged[card]

    def _chunks(self, n: int):
        for i, start in enumerate(range(0, n, self.chunk_bytes)):
            yield i % 2, slice(start, min(start + self.chunk_bytes, n))

    def _to_host(self, src, dst, buffers, events) -> None:
        """Card -> host: the copy engine fills buffer b while the host
        drains the other, filled one chunk earlier."""
        pending = None
        for b, part in self._chunks(src.numel()):
            n = part.stop - part.start
            buffers[b][:n].copy_(src[part], non_blocking=True)
            events[b].record()
            if pending is not None:
                self._drain(pending, dst, buffers, events)
            pending = (b, part)
        if pending is not None:
            self._drain(pending, dst, buffers, events)

    @staticmethod
    def _drain(pending, dst, buffers, events) -> None:
        b, part = pending
        events[b].synchronize()
        dst[part].copy_(buffers[b][:part.stop - part.start])

    def _to_card(self, src, dst, buffers, events) -> None:
        """Host -> card: the host fills buffer b once the copy engine has
        read it (its event), then queues its copy to the card."""
        for b, part in self._chunks(src.numel()):
            n = part.stop - part.start
            events[b].synchronize()
            buffers[b][:n].copy_(src[part])
            dst[part].copy_(buffers[b][:n], non_blocking=True)
            events[b].record()


class ModelStore:
    """P2P weight transport stand-in: tx_id -> model pytree.

    Peers share one card here, so the store is an in-memory map of model
    trees: the DAG provably never carries weights.

    ``device`` says where the stored models rest.  ``None`` (the
    reference's map) keeps each model where it was produced and hands the
    same objects back.  A device (``"cpu"``: host memory, the port's own
    choice for models that the card cannot hold beside a training client)
    makes the store keep each model there: :meth:`put` copies in what
    rests elsewhere (:meth:`rest`), and each read copies the model out to
    the device the reader names, so a reader's in-place change never
    reaches the stored model; :meth:`mean` copies one leaf of each model
    at a time.  A store that rests models on the card raises when the card
    is full; nothing moves to the host on its own.  Copies between the
    host and a card go through :class:`PinnedStaging`.

    ``bytes_transferred`` counts every read as the reference counts a
    ``get``.  ``readings()`` adds the store's own copy bytes and seconds
    each way and the peak bytes resting in it.
    """

    def __init__(self, device=None):
        self.device = None if device is None else _indexed(device)
        self._store: Dict[str, object] = {}
        self.bytes_transferred = 0
        self._staging = PinnedStaging()
        self._copied = {"in": [0, 0.0], "out": [0, 0.0]}   # bytes, seconds
        self._resting_bytes = 0
        self._peak_resting_bytes = 0

    def put(self, key: str, model) -> str:
        if self.device is not None:
            self.evict(key)
            model = self.rest(model)
            self._resting_bytes += tree_size_bytes(model)
            self._peak_resting_bytes = max(self._peak_resting_bytes,
                                           self._resting_bytes)
        self._store[key] = model
        return key

    def rest(self, model):
        """``model`` on the resting device: its leaves already there are
        kept, the others copied in (the same tree without a device)."""
        if self.device is None:
            return model
        away = [leaf for leaf in tree_leaves(model)
                if isinstance(leaf, torch.Tensor)
                and leaf.device != self.device]
        with self._timed("in", [leaf.device for leaf in away]):
            return tree_map(lambda leaf: leaf if not isinstance(
                leaf, torch.Tensor) or leaf.device == self.device
                else self._copy(leaf, self.device, "in"), model)

    def get(self, key: str, device=None):
        """The model stored under ``key``; where the store rests models, a
        copy of it on ``device`` (default: the resting device)."""
        model = self._read(key)
        if self.device is None:
            return model
        device = self._target(device)
        with self._timed("out", [device]):
            return tree_map(lambda leaf: self._copy(leaf, device, "out"),
                            model)

    def mean(self, refs: Sequence[str], device=None):
        """Eq. 6 over the models stored under ``refs``: ``tree_mean``'s
        bits over the models :meth:`get` would return on ``device``.  Where
        the store rests models, it copies the k models' copies of one leaf
        at a time to ``device`` and adds them there
        (``core.aggregate.leaf_mean``), so ``device`` holds at most the
        result and k copies of one leaf.  Each ref counts as one
        :meth:`get`."""
        models = [self._read(r) for r in refs]
        if self.device is None:
            return tree_mean(models)
        device = self._target(device)
        with self._timed("out", [device]):
            return tree_map(lambda *leaves: leaf_mean(
                [self._copy(leaf, device, "out") for leaf in leaves]),
                *models)

    def _read(self, key: str):
        model = self._store[key]
        self.bytes_transferred += tree_size_bytes(model)
        return model

    def _target(self, device) -> torch.device:
        return self.device if device is None else _indexed(device)

    def _copy(self, leaf, device: torch.device, way: str):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        self._copied[way][0] += leaf.numel() * leaf.element_size()
        return self._staging.copy(leaf, device)

    @contextmanager
    def _timed(self, way: str, devices: Iterable[torch.device]):
        """The seconds of one tree's copies (of one :meth:`mean`, its adds
        on the card too), added to ``way``'s: each card involved finishes
        the work queued before, which is not counted, and the copies."""
        cards = {d for d in (*devices, self.device)
                 if d is not None and d.type == "cuda"}
        for card in cards:
            torch.cuda.synchronize(card)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for card in cards:
                torch.cuda.synchronize(card)
            self._copied[way][1] += time.perf_counter() - t0

    def readings(self) -> Dict[str, object]:
        """Copy bytes and seconds into the store (``in``: each
        :meth:`put`) and out of it (``out``: each read; a :meth:`mean`'s
        seconds include its adds, which read each copy once more at the
        card's memory rate), the bytes resting in it now and at most, and
        the devices its leaves rest on."""
        return {"device": None if self.device is None else str(self.device),
                "in_bytes": self._copied["in"][0],
                "in_s": self._copied["in"][1],
                "out_bytes": self._copied["out"][0],
                "out_s": self._copied["out"][1],
                "resting_bytes": self._resting_bytes,
                "peak_resting_bytes": self._peak_resting_bytes,
                "resting_devices": sorted({
                    str(leaf.device) for model in self._store.values()
                    for leaf in tree_leaves(model)
                    if isinstance(leaf, torch.Tensor)})}

    def evict(self, key: str):
        model = self._store.pop(key, None)
        if model is not None and self.device is not None:
            self._resting_bytes -= tree_size_bytes(model)

    def __contains__(self, key):
        return key in self._store

    def __len__(self):
        return len(self._store)


class DAGLedger:
    """Append-only DAG of transactions with tip tracking."""

    # 12-digit ids keep lexicographic order == numeric insertion order up
    # to 10^12 transactions.  The old 6-digit padding silently broke every
    # sorted-id iteration (tips(), reachable splits, top-up determinism)
    # past the 999999 -> 1000000 boundary.
    ID_DIGITS = 12

    def __init__(self):
        self._nodes: Dict[str, Transaction] = {}
        self._children: Dict[str, List[str]] = {}
        self._tips: set = set()
        self.genesis_id: Optional[str] = None
        self._counter = 0
        # per-client latest-transaction index: ``latest_of`` sits on the
        # coordinator's hot path (once per round per client plus the final
        # sweep), so an O(ledger) scan per call turns quadratic — keep it
        # O(1) by updating on append.  Only (tx_id, timestamp) is retained
        # so a pruned transaction's body is not pinned by the index.
        self._latest: Dict[int, Tuple[str, float]] = {}

    # -- construction -------------------------------------------------------

    def add_genesis(self, metadata: TxMetadata, timestamp: float = 0.0,
                    model_ref: str = "") -> Transaction:
        assert self.genesis_id is None, "genesis already exists"
        tx = self._make_tx(metadata, (), timestamp, model_ref)
        self.genesis_id = tx.tx_id
        return tx

    def add_transaction(self, metadata: TxMetadata, parents: Sequence[str],
                        timestamp: float, model_ref: str = "") -> Transaction:
        for p in parents:
            if not self._parent_known(p):
                raise KeyError(f"unknown parent {p}")
        return self._make_tx(metadata, tuple(parents), timestamp, model_ref)

    def _parent_known(self, tx_id: str) -> bool:
        return tx_id in self._nodes

    def _make_tx(self, metadata, parents, timestamp, model_ref) -> Transaction:
        tx_id = f"tx{self._counter:0{self.ID_DIGITS}d}"
        seq = self._counter
        self._counter += 1
        parent_hashes = [self.hash_of(p) for p in parents]
        tx = Transaction(tx_id=tx_id, metadata=metadata, parents=parents,
                         timestamp=timestamp,
                         tx_hash=compute_tx_hash(parent_hashes, metadata),
                         model_ref=model_ref or tx_id, seq=seq)
        self._nodes[tx_id] = tx
        self._children[tx_id] = []
        for p in parents:
            if p in self._children:         # pruned parents keep no edge list
                self._children[p].append(tx_id)
            self._tips.discard(p)
        self._tips.add(tx_id)
        # >= keeps the old full-scan tie-break: among equal timestamps the
        # latest-inserted transaction wins
        prev = self._latest.get(metadata.client_id)
        displaced = None
        if prev is None or timestamp >= prev[1]:
            self._latest[metadata.client_id] = (tx_id, timestamp)
            displaced = prev[0] if prev is not None else None
        self._on_append(tx, displaced)
        return tx

    def _on_append(self, tx: Transaction, displaced: Optional[str]) -> None:
        """Index-maintenance hook for subclasses (no-op here).  ``displaced``
        is the client's previous latest tx iff this append replaced it."""

    # -- queries ------------------------------------------------------------

    def tips(self) -> List[str]:
        """Transactions with in-degree 0 (unapproved)."""
        return sorted(self._tips)

    def tips_by_freshness(self, limit: Optional[int] = None) -> List[str]:
        """Tips ordered most-recent first (timestamp desc, id asc on ties).
        The reference ledger sorts on demand; :class:`BoundedDAGLedger`
        serves the same order from an incrementally maintained heap."""
        out = sorted(self._tips,
                     key=lambda t: (-self._nodes[t].timestamp, t))
        return out if limit is None else out[:limit]

    def latest_of(self, client_id: int) -> Optional[str]:
        """O(1): served from the per-client index maintained in _make_tx."""
        entry = self._latest.get(client_id)
        return entry[0] if entry is not None else None

    def head_seq(self) -> int:
        """Append seq of the most recent transaction (-1 before genesis).
        Monotone across pruning — this is the ledger-position clock that
        serving staleness (frontier-to-replica lag) is measured against:
        unlike wall/sim time it advances exactly once per publish, so lag
        counters are deterministic event counts."""
        return self._counter - 1

    def reachable_tips(self, start_node: Optional[str],
                       within: Optional[Iterable[str]] = None
                       ) -> Tuple[List[str], List[str]]:
        """Paper Alg. 1: BFS from the client's latest node over approval
        children; returns (ReachableTips, UnreachableTips).  ``within``
        restricts the split to a candidate subset of the tips (the
        index-backed selection path passes its freshness-capped candidates
        so large populations never pay an all-tips scan per query)."""
        if within is None:
            all_tips = set(self._tips)
        else:
            all_tips = {t for t in within if t in self._tips}
        if start_node is None or not self._start_known(start_node):
            return [], sorted(all_tips)
        if self.is_pruned(start_node):
            # confirmed == every current tip transitively approves it, and
            # confirmation is monotone (new transactions approve existing
            # tips), so a pruned start reaches the whole tip set
            return sorted(all_tips), []
        reachable = self._reach_from(start_node, all_tips)
        return sorted(reachable), sorted(all_tips - reachable)

    def _start_known(self, tx_id: str) -> bool:
        return tx_id in self._nodes or self.is_pruned(tx_id)

    def _reach_from(self, start_node: str, all_tips: set) -> set:
        visited = {start_node}
        q = deque([start_node])
        reachable = set()
        while q:
            node = q.popleft()
            if node in all_tips:
                reachable.add(node)
            for ch in self._children[node]:
                if ch not in visited:
                    visited.add(ch)
                    q.append(ch)
        return reachable

    def ancestors(self, tx_id: str, max_depth: Optional[int] = None):
        """Walk parent links over the LIVE region (used by verification
        paths); stops at the pruned boundary on a bounded ledger."""
        out, depth = [], 0
        frontier = [p for p in self.get_tx(tx_id).parents if self.has_tx(p)]
        seen = set(frontier)
        while frontier and (max_depth is None or depth < max_depth):
            out.extend(frontier)
            nxt = []
            for f in frontier:
                for p in self._nodes[f].parents:
                    if p not in seen and p in self._nodes:
                        seen.add(p)
                        nxt.append(p)
            frontier = nxt
            depth += 1
        return out

    def get_tx(self, tx_id: str) -> Transaction:
        return self._nodes[tx_id]

    def has_tx(self, tx_id: str) -> bool:
        return tx_id in self._nodes

    def is_pruned(self, tx_id: str) -> bool:
        return False

    def hash_of(self, tx_id: str) -> str:
        """Eq. 7 hash of a live (or, on a bounded ledger, pruned) tx."""
        return self._nodes[tx_id].tx_hash

    def transactions(self) -> Iterator[Transaction]:
        """Live transactions in append order."""
        return iter(self._nodes.values())

    @property
    def checkpoints(self) -> Sequence[CheckpointRecord]:
        return ()

    def __len__(self):
        return len(self._nodes)


class _ReachSummary:
    """Incremental reachability state for one start transaction.

    ``visited`` is the known descendant set of ``start`` (including it);
    ``cursor`` is the last append seq folded in.  Because appends only ever
    ADD descendants, a query needs to process just the transactions
    appended since ``cursor`` — O(new appends), not O(live region).
    """

    __slots__ = ("start", "visited", "cursor")

    def __init__(self, start: str, seq: int):
        self.start = start
        self.visited = {start}
        self.cursor = seq


class BoundedDAGLedger(DAGLedger):
    """DAG ledger with a bounded consensus frontier (see module docstring).

    ``checkpoint_interval`` > 0 folds confirmed ancestry automatically every
    that many appends; ``checkpoint()`` may also be driven externally (the
    coordinator hooks it onto the simulated clock).  ``evict_fn`` receives
    each pruned transaction so the caller can drop its ModelStore entry.

    Invariant maintained by pruning: the pruned set is ancestor-closed
    (parents of a pruned tx are pruned), so a live transaction never has a
    pruned child and downward BFS over live nodes is exact for live starts.
    """

    def __init__(self, checkpoint_interval: int = 0,
                 evict_fn: Optional[Callable[[Transaction], None]] = None,
                 max_summaries: int = 65536,
                 summary_cap: int = 65536):
        super().__init__()
        self.checkpoint_interval = int(checkpoint_interval)
        self.evict_fn = evict_fn
        self._pruned_hashes: Dict[str, str] = {}
        self._checkpoints: List[CheckpointRecord] = []
        self._appends_since_ckpt = 0
        # freshness-ordered tip index: lazy-deletion heap of
        # (-timestamp, tx_id); stale entries (no longer tips) are skipped
        # on query and swept wholesale at checkpoint time
        self._tip_heap: List[Tuple[float, str]] = []
        # per-start incremental reachability summaries, keyed by start tx.
        # One summary per client's latest transaction; bounded in count
        # (max_summaries, FIFO eviction) and per-summary size (summary_cap,
        # overflow falls back to frontier-bounded BFS).
        self._reach: Dict[str, _ReachSummary] = {}
        self.max_summaries = max_summaries
        self.summary_cap = summary_cap
        # seq-ordered log of live transactions for summary catch-up;
        # compacted to the live set at each checkpoint
        self._log: List[Transaction] = []
        self._log_seqs: List[int] = []
        # deterministic work counters (perf-gate instrumentation)
        self.stat_reach_processed = 0     # log entries folded into summaries
        self.stat_reach_bfs = 0           # nodes visited by BFS fallbacks
        self.stat_tip_heap_pops = 0       # heap entries popped (incl. stale)

    # -- append-side index maintenance --------------------------------------

    def _parent_known(self, tx_id: str) -> bool:
        # a parent selected as a tip may be confirmed+pruned before its
        # approver publishes (async publish lag); its Eq. 7 hash survives
        # in the retained-hash map, so the approval stays verifiable
        return tx_id in self._nodes or tx_id in self._pruned_hashes

    def hash_of(self, tx_id: str) -> str:
        tx = self._nodes.get(tx_id)
        if tx is not None:
            return tx.tx_hash
        return self._pruned_hashes[tx_id]

    def is_pruned(self, tx_id: str) -> bool:
        return tx_id in self._pruned_hashes

    def _on_append(self, tx: Transaction, displaced: Optional[str]) -> None:
        heapq.heappush(self._tip_heap, (-tx.timestamp, tx.tx_id))
        self._log.append(tx)
        self._log_seqs.append(tx.seq)
        # a client's reachability start moves to its new transaction: the
        # old summary can never be queried again
        if displaced is not None:
            self._reach.pop(displaced, None)
        if len(self._reach) < self.max_summaries:
            self._reach[tx.tx_id] = _ReachSummary(tx.tx_id, tx.seq)
        self._appends_since_ckpt += 1
        if (self.checkpoint_interval
                and self._appends_since_ckpt >= self.checkpoint_interval):
            self.checkpoint(now=tx.timestamp)

    # -- freshness-ordered tip index ----------------------------------------

    def tips_by_freshness(self, limit: Optional[int] = None) -> List[str]:
        if limit is None or limit >= len(self._tips):
            return super().tips_by_freshness(limit)
        out: List[str] = []
        kept: List[Tuple[float, str]] = []
        heap = self._tip_heap
        while heap and len(out) < limit:
            entry = heapq.heappop(heap)
            self.stat_tip_heap_pops += 1
            if entry[1] in self._tips:
                out.append(entry[1])
                kept.append(entry)
        for entry in kept:                 # tips stay in the index
            heapq.heappush(heap, entry)
        return out

    # -- index-backed reachability ------------------------------------------

    def _reach_from(self, start_node: str, all_tips: set) -> set:
        summary = self._reach.get(start_node)
        if summary is None:
            self.stat_reach_bfs += 1
            visited = super()._reach_from(start_node, all_tips)
            self.stat_reach_bfs += len(visited)
            return visited
        if summary.cursor < self._counter - 1:
            lo = self._bisect_log(summary.cursor)
            for tx in self._log[lo:]:
                if tx.tx_id in summary.visited:
                    continue
                for p in tx.parents:
                    if p in summary.visited:
                        summary.visited.add(tx.tx_id)
                        break
                self.stat_reach_processed += 1
            summary.cursor = self._counter - 1
        if len(summary.visited) > self.summary_cap:
            self._reach.pop(start_node, None)
        return {t for t in all_tips if t in summary.visited}

    def _bisect_log(self, cursor: int) -> int:
        import bisect
        return bisect.bisect_right(self._log_seqs, cursor)

    # -- checkpoint + prune --------------------------------------------------

    def confirmed(self) -> set:
        """Transactions every current tip transitively approves (proper
        common ancestors of the tip set).

        One reverse-topological pass over the live region with per-node
        reached-tip bitmasks: children always have a larger append seq than
        their parents, so processing live transactions in descending seq
        order makes ``mask(n) = own_bit | OR(mask(children))`` exact — n is
        confirmed iff its mask covers every tip.  O(live * avg_out_degree)
        bigint ORs, vs the O(|tips| * live) per-tip ancestor walks this
        replaced (which dominated checkpoint cost at 10^5 clients).
        """
        tips = sorted(self._tips)
        if not tips:
            return set()
        bit = {t: 1 << i for i, t in enumerate(tips)}
        full = (1 << len(tips)) - 1
        mask: Dict[str, int] = {}
        out = set()
        for tx in sorted(self._nodes.values(), key=lambda x: -x.seq):
            m = bit.get(tx.tx_id, 0)
            for ch in self._children[tx.tx_id]:
                m |= mask[ch]
            mask[tx.tx_id] = m
            if m == full and tx.tx_id not in bit:
                out.add(tx.tx_id)
        return out

    def maybe_checkpoint(self, now: float = 0.0,
                         min_appends: int = 1) -> Optional[CheckpointRecord]:
        """Checkpoint if at least ``min_appends`` landed since the last one
        (the coordinator's simulated-clock cadence hook)."""
        if self._appends_since_ckpt < min_appends:
            return None
        return self.checkpoint(now)

    def checkpoint(self, now: float = 0.0) -> Optional[CheckpointRecord]:
        """Fold the currently confirmed region into a checkpoint record and
        evict its bodies.  Returns the record, or None if nothing confirmed.
        """
        self._appends_since_ckpt = 0
        confirmed = self.confirmed()
        if not confirmed:
            return None
        leaves = [(t, self._nodes[t].tx_hash) for t in confirmed]
        prev_root = (self._checkpoints[-1].root if self._checkpoints
                     else GENESIS_ROOT)
        rec = CheckpointRecord(
            ckpt_id=f"ckpt{len(self._checkpoints):06d}",
            seq=len(self._checkpoints), created_at=float(now),
            n_pruned=len(confirmed),
            root=checkpoint_root(prev_root, leaves), prev_root=prev_root,
            leaf_ids=tuple(sorted(confirmed)))
        self._checkpoints.append(rec)
        for t in confirmed:
            tx = self._nodes.pop(t)
            self._children.pop(t, None)
            self._pruned_hashes[t] = tx.tx_hash
            self._reach.pop(t, None)
            if self.evict_fn is not None:
                self.evict_fn(tx)
        # compact the indexes to the live set: summary catch-up may skip
        # pruned entries entirely (a confirmed tx is never a descendant of
        # a live, unconfirmed start — see DESIGN.md)
        self._log = [tx for tx in self._log if tx.tx_id in self._nodes]
        self._log_seqs = [tx.seq for tx in self._log]
        self._tip_heap = [e for e in self._tip_heap if e[1] in self._tips]
        heapq.heapify(self._tip_heap)
        return rec

    @property
    def checkpoints(self) -> Sequence[CheckpointRecord]:
        return tuple(self._checkpoints)

    @property
    def n_pruned(self) -> int:
        return len(self._pruned_hashes)

    # test/audit access: the retained Eq. 7 hash of one pruned transaction
    def pruned_hash(self, tx_id: str) -> str:
        return self._pruned_hashes[tx_id]

    def _tamper_pruned_hash(self, tx_id: str, value: str) -> None:
        """Test hook: corrupt a retained hash (simulated checkpoint tamper)."""
        self._pruned_hashes[tx_id] = value
