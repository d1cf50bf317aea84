"""Textbook two-phase commit (R* style, paper §2.2/§6.1) over speculative
logs. The protocol is UNCHANGED; only the persistence behaviour differs:

  * baseline (``speculative=False``): the coordinator logs start-of-commit
    before PREPARE, every participant logs its vote before replying, and the
    coordinator logs the decision before notifying — each a synchronous
    group-commit wait (this is why baseline commit latency clusters at
    multiples of the 10 ms group-commit period, paper Fig. 11);
  * speculative (``speculative=True``): identical log appends proceed
    without waiting; one speculation barrier before acknowledging the client
    hides all of it, so the persists of all parties overlap (latency ≈ max,
    not sum).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core.ids import Header
from .spec_log import SpeculativeLog


class TwoPCParticipant(SpeculativeLog):
    def __init__(self, root: Path, speculative: bool = True) -> None:
        super().__init__(root)
        self.speculative = speculative
        self._txn_started: Dict[str, bool] = {}

    def on_crash(self) -> None:  # volatile index rebuilt lazily from log
        super().on_crash()
        self._txn_started = {}

    def _rebuild_index(self) -> None:
        self._txn_started = {}
        for _, e in self.core.scan(0):
            kind, txn = e.decode().split(":", 1)
            if kind == "start":
                self._txn_started[txn] = True

    def txn_start(self, txn: str, header: Optional[Header] = None):
        """Client writes a start record (without waiting for persistence —
        paper §6.1 benchmark definition)."""
        if not self.StartAction(header):
            return None
        self.core.append(f"start:{txn}".encode())
        self._txn_started[txn] = True
        return self.EndAction()

    def prepare(self, txn: str, header: Optional[Header] = None):
        """Vote yes iff the start record survives (it is lost only after a
        failure rolled it back). Baseline logs the vote durably first."""
        if not self.StartAction(header):
            return None
        if txn not in self._txn_started and self.core.tail() > 0:
            self._rebuild_index()
        vote = self._txn_started.get(txn, False)
        self.core.append(f"vote:{txn}:{'y' if vote else 'n'}".encode())
        if not self.speculative:
            if not self.wait_durable(timeout=30.0):
                return None
        return vote, self.EndAction()

    def decide(self, txn: str, commit: bool, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        self.core.append(f"decide:{txn}:{'c' if commit else 'a'}".encode())
        return self.EndAction()


class TwoPCCoordinator(SpeculativeLog):
    def __init__(self, root: Path, speculative: bool = True) -> None:
        super().__init__(root)
        self.speculative = speculative

    def commit_txn(
        self,
        txn: str,
        participants: List[TwoPCParticipant],
        header: Optional[Header] = None,
    ) -> Optional[Tuple[bool, Header]]:
        """Run the commit protocol; returns (committed, hdr) once the outcome
        is externally safe, or None if this coordinator state rolled back."""
        if not self.StartAction(header):
            return None
        self.core.append(f"begin:{txn}".encode())
        if not self.speculative:
            if not self.wait_durable(timeout=30.0):
                return None
        t = self.Detach()

        # Phase 1: PREPARE
        votes: List[bool] = []
        for p in participants:
            out = p.prepare(txn, t.Send())
            if out is None:
                return None
            vote, rh = out
            if not t.Receive(rh):
                return None
            votes.append(vote)
        commit = all(votes)

        if not self.Merge(t):
            return None
        self.core.append(f"decision:{txn}:{'c' if commit else 'a'}".encode())
        if not self.speculative:
            if not self.wait_durable(timeout=30.0):
                return None
        t = self.Detach()

        # Phase 2: notify participants (need not block client ack)
        for p in participants:
            out = p.decide(txn, commit, t.Send())
            if out is None:
                return None
            if not t.Receive(out):
                return None

        if self.speculative:
            # single barrier replaces all synchronous waits above
            t.Barrier(timeout=30.0)
        if not self.Merge(t):
            return None
        return commit, self.EndAction()


class TwoPCClient:
    """Closed-loop transactional client (paper §6.1): writes a start record
    to every participant without waiting, then asks the coordinator to run
    commit."""

    def __init__(self, coordinator: TwoPCCoordinator, participants: List[TwoPCParticipant]):
        self.coordinator = coordinator
        self.participants = participants

    def run(self, txn: str) -> Optional[bool]:
        for p in self.participants:
            if p.txn_start(txn) is None:
                return None
        out = self.coordinator.commit_txn(txn, self.participants)
        if out is None:
            return None
        committed, _ = out
        return committed
