"""The DAG ledger (IOTA-style tangle) that DAG-AFL coordinates over.

PyTorch port of ``repro.core.dag``: the ledger is framework-free and is
copied as it is, so hashes, tips and reachability agree with the reference
on the same operation sequence.  Only :meth:`ModelStore.get` differs: it
counts the bytes of a model tree of torch tensors.

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
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Protocol, Sequence, Tuple, runtime_checkable)

from repro_torch.core.aggregate import tree_size_bytes


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


class ModelStore:
    """P2P weight transport stand-in: tx_id -> model pytree.

    Peers share one card here, so the store is an in-memory map of model
    trees: the DAG provably never carries weights.
    """

    def __init__(self):
        self._store: Dict[str, object] = {}
        self.bytes_transferred = 0

    def put(self, key: str, model) -> str:
        self._store[key] = model
        return key

    def get(self, key: str):
        model = self._store[key]
        self.bytes_transferred += tree_size_bytes(model)
        return model

    def evict(self, key: str):
        self._store.pop(key, None)

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
