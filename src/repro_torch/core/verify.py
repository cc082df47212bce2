"""Trustworthy verification of the DAG (paper §III-C, Eq. 7).

The task publisher holds the full DAG; trainers keep only *validation paths*
(the hash chain from a tip back to genesis).  Re-deriving every hash along a
stored path and comparing against the path's recorded values detects any
tampering of metadata or structure by the publisher.

On a :class:`~repro_torch.core.dag.BoundedDAGLedger` the pruned region's
bodies are gone, but each pruned transaction's Eq. 7 hash survives in the
checkpoint rollup, so a stored path record that crosses the pruned boundary
is still checkable: its hash must re-derive from the record's own parents +
metadata digest AND match the retained checkpoint hash.  ``verify_full_dag``
additionally re-derives every checkpoint root so tampering with the
retained-hash map itself is caught.

:class:`IncrementalVerifier` is the publisher's steady-state audit: it
hash-checks only the transactions (and checkpoints) appended since the last
audit instead of re-walking all history.

PyTorch port of ``repro.core.verify``, copied as it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.dag import (GENESIS_ROOT, LedgerView,
                                  checkpoint_root, compute_tx_hash,
                                  compute_tx_hash_from_digest)


@dataclass(frozen=True)
class PathRecord:
    tx_id: str
    tx_hash: str
    parents: Tuple[str, ...]
    metadata_digest: str


@dataclass
class ValidationPath:
    """What a trainer stores: hash-chain records from a tip to genesis."""

    tip_id: str
    records: List[PathRecord]


def extract_path(ledger: LedgerView, tip_id: str) -> ValidationPath:
    """Walk first-parent links from ``tip_id``, recording hashes; ends at
    genesis or, on a bounded ledger, at the pruned (checkpoint) boundary."""
    records = []
    cur: Optional[str] = tip_id
    while cur is not None and ledger.has_tx(cur):
        tx = ledger.get_tx(cur)
        records.append(PathRecord(tx.tx_id, tx.tx_hash, tx.parents,
                                  tx.metadata.digest()))
        cur = tx.parents[0] if tx.parents else None
    return ValidationPath(tip_id=tip_id, records=records)


def _record_parent_hashes(ledger: LedgerView,
                          parents: Tuple[str, ...]) -> List[str]:
    """Hashes for a record's claimed parents, live or pruned; unknown
    parents are skipped (their absence surfaces as a hash mismatch)."""
    return [ledger.hash_of(p) for p in parents
            if ledger.has_tx(p) or ledger.is_pruned(p)]


def verify_path(ledger: LedgerView, path: ValidationPath) -> Tuple[bool, str]:
    """Re-derive each hash on the stored path from the publisher's current
    DAG state; any mismatch => tampering.  Returns (ok, reason)."""
    for rec in path.records:
        if ledger.has_tx(rec.tx_id):
            tx = ledger.get_tx(rec.tx_id)
            if tx.parents != rec.parents:
                return False, f"{rec.tx_id}: approval edges changed"
            if tx.metadata.digest() != rec.metadata_digest:
                return False, f"{rec.tx_id}: metadata digest mismatch"
            recomputed = compute_tx_hash(
                _record_parent_hashes(ledger, tx.parents), tx.metadata)
            if recomputed != rec.tx_hash:
                return False, f"{rec.tx_id}: hash mismatch (Eq. 7 recompute)"
        elif ledger.is_pruned(rec.tx_id):
            # body pruned: the record's own parents + digest must re-derive
            # its hash AND agree with the checkpoint-retained hash
            recomputed = compute_tx_hash_from_digest(
                _record_parent_hashes(ledger, rec.parents),
                rec.metadata_digest)
            if recomputed != rec.tx_hash:
                return False, (f"{rec.tx_id}: pruned-record hash mismatch "
                               f"(Eq. 7 recompute)")
            if ledger.hash_of(rec.tx_id) != rec.tx_hash:
                return False, (f"{rec.tx_id}: retained checkpoint hash "
                               f"mismatch")
        else:
            return False, f"{rec.tx_id}: transaction missing from DAG"
    return True, "ok"


def verify_checkpoints(ledger: LedgerView) -> Tuple[bool, str]:
    """Re-derive every checkpoint's merkle-style root from the retained
    leaf hashes; detects tampering of the pruned region's rollup."""
    prev_root = GENESIS_ROOT
    for rec in ledger.checkpoints:
        if rec.prev_root != prev_root:
            return False, f"{rec.ckpt_id}: checkpoint chain broken"
        try:
            leaves = [(t, ledger.hash_of(t)) for t in rec.leaf_ids]
        except KeyError as e:
            return False, f"{rec.ckpt_id}: retained hash missing for {e}"
        if checkpoint_root(prev_root, leaves) != rec.root:
            return False, f"{rec.ckpt_id}: checkpoint root does not re-derive"
        prev_root = rec.root
    return True, "ok"


def detect_tampered(ledger: LedgerView) -> List[str]:
    """Counting tamper sweep: re-derive Eq. 7 for EVERY live transaction
    and return all ids whose stored hash does not re-derive (sorted for
    determinism).  ``verify_full_dag`` stops at the first failure — the
    robustness benchmark gates on exact detection counts, so it needs the
    complete set.  Metadata tampering breaks only the victim's own hash
    (children committed to the parent's stored tx_hash, which the attacker
    left in place), so the sweep returns exactly the tampered set."""
    bad = []
    for tx in ledger.transactions():
        try:
            parent_hashes = [ledger.hash_of(p) for p in tx.parents]
        except KeyError:
            bad.append(tx.tx_id)
            continue
        if compute_tx_hash(parent_hashes, tx.metadata) != tx.tx_hash:
            bad.append(tx.tx_id)
    return sorted(bad)


def verify_full_dag(ledger: LedgerView) -> Tuple[bool, str]:
    """Publisher-side audit: every stored hash must re-derive (Eq. 7),
    live transactions against parent hashes (retained ones for pruned
    parents), plus every checkpoint root against its retained leaves."""
    for tx in ledger.transactions():
        try:
            parent_hashes = [ledger.hash_of(p) for p in tx.parents]
        except KeyError:
            return False, f"{tx.tx_id}: parent hash unavailable"
        if compute_tx_hash(parent_hashes, tx.metadata) != tx.tx_hash:
            return False, f"{tx.tx_id}: stored hash does not re-derive"
    return verify_checkpoints(ledger)


class IncrementalVerifier:
    """Audits only what changed since the last audit.

    ``audit()`` re-derives Eq. 7 for transactions with append seq beyond
    the last audited one and re-derives roots of checkpoints created since,
    so steady-state audit cost tracks the append rate, not total history.
    ``txs_checked`` / ``checkpoints_checked`` count cumulative work (the
    benchmark gates on them being ~O(appends), not O(history^2)).
    """

    def __init__(self, ledger: LedgerView):
        self.ledger = ledger
        self._last_seq = -1
        self._last_ckpt = 0
        self.txs_checked = 0
        self.checkpoints_checked = 0

    def audit(self) -> Tuple[bool, str]:
        led = self.ledger
        max_seq = self._last_seq
        for tx in led.transactions():
            if tx.seq <= self._last_seq:
                continue
            try:
                parent_hashes = [led.hash_of(p) for p in tx.parents]
            except KeyError:
                return False, f"{tx.tx_id}: parent hash unavailable"
            if compute_tx_hash(parent_hashes, tx.metadata) != tx.tx_hash:
                return False, f"{tx.tx_id}: stored hash does not re-derive"
            self.txs_checked += 1
            max_seq = max(max_seq, tx.seq)
        ckpts = led.checkpoints
        prev_root = (ckpts[self._last_ckpt - 1].root
                     if self._last_ckpt else GENESIS_ROOT)
        for rec in ckpts[self._last_ckpt:]:
            if rec.prev_root != prev_root:
                return False, f"{rec.ckpt_id}: checkpoint chain broken"
            try:
                leaves = [(t, led.hash_of(t)) for t in rec.leaf_ids]
            except KeyError as e:
                return False, f"{rec.ckpt_id}: retained hash missing for {e}"
            if checkpoint_root(prev_root, leaves) != rec.root:
                return False, (f"{rec.ckpt_id}: checkpoint root does not "
                               f"re-derive")
            prev_root = rec.root
            self.checkpoints_checked += 1
        self._last_ckpt = len(ckpts)
        self._last_seq = max_seq
        return True, "ok"
