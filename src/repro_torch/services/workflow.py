"""Speculative workflow orchestration engine (paper §5.2, "Speculative
Workflows") — the core backend of a Temporal/Durable-Functions-style
engine, following the CReSt model: every workflow transition is an atomic
state change on speculatively-persisted state.

Control flow is part of persisted state (paper §4.1.1): the recorded step
index rolls back together with everything else, so after recovery the
workflow resumes "from exactly where it is supposed to" — re-invoking
``run_workflow`` with the same id continues from the surviving step index.

The current-generation durable-execution baseline (Temporal/Beldi/
Boki-style per-transition synchronous persistence, the paper's Figure-9
baseline) is no longer a bespoke flag here: deploy the engine with
``runtime="durable"`` (:class:`~repro.durable.DurableRuntime`) and every
``Detach``/``EndAction`` below becomes a synchronous durability wait — the
orchestration code is identical on both runtimes.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..core.ids import Header
from ..core.state_object import StateObject, VersionStore
from ..core.sthread import RolledBackError

#: a workflow step: takes an outgoing header, performs the (remote) call,
#: returns (result, response_header) — or None if the callee discarded us.
Step = Callable[[Header], Optional[Tuple[object, Header]]]


class WorkflowEngine(StateObject):
    def __init__(self, root: Path, io_ms: float = 0.0) -> None:
        super().__init__()
        self.store = VersionStore(root, simulate_io_ms=io_ms)
        self._wfs: Dict[str, dict] = {}
        self._mu = threading.Lock()

    # -- persistence backend -------------------------------------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        with self._mu:
            payload = json.dumps(self._wfs).encode()

        def _io() -> None:
            try:
                self.store.write(version, payload, metadata)
            except RuntimeError:
                return
            callback()

        self.spawn_io(_io)

    def Restore(self, version: int) -> bytes:
        payload, meta = self.store.read(version)
        with self._mu:
            self._wfs = json.loads(payload.decode())
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        self.store.prune(version)

    def on_crash(self) -> None:
        self.store.poison()
        self.store.drop_memory()
        with self._mu:
            self._wfs = {}

    # -- orchestration (paper Fig. 5) ------------------------------------------
    def run_workflow(
        self,
        wf_id: str,
        steps: List[Step],
        header: Optional[Header] = None,
        external: bool = True,
    ):
        """Execute (or resume) workflow ``wf_id``. Returns (results, header)
        once the outcome is safe to expose, or None if rolled back mid-way
        (the driver retries; surviving progress is preserved)."""
        if not self.StartAction(header):
            return None
        with self._mu:
            wf = self._wfs.setdefault(
                wf_id, {"status": "running", "step": 0, "results": []}
            )
            start_step = int(wf["step"])
        t = self.Detach()  # leave the atomic block: calls are long-running

        for i in range(start_step, len(steps)):
            try:
                out = steps[i](t.Send())
            except RolledBackError:
                return None
            if out is None:
                return None  # callee discarded our speculative message
            result, rh = out
            try:
                if not t.Receive(rh):
                    return None
            except RolledBackError:
                return None
            if not self.Merge(t):
                return None  # our own state rolled back; driver will resume
            with self._mu:
                wf = self._wfs[wf_id]
                wf["results"].append(result)
                wf["step"] = i + 1
            t = self.Detach()

        if not self.Merge(t):
            return None
        with self._mu:
            self._wfs[wf_id]["status"] = "done"
            results = list(self._wfs[wf_id]["results"])
        t = self.Detach()
        if external:
            # Failure transparency: only non-speculative results leave (§3.2).
            try:
                t.Barrier(timeout=30.0)
            except RolledBackError:
                return None
            if not self.Merge(t):
                return None
            return results, self.EndAction()
        # internal caller: pass speculation onward via the header
        h = t.Send()
        return results, h

    # -- recovery driver --------------------------------------------------------
    def pending_workflows(self) -> List[str]:
        """Workflows whose recorded status is not done (driver re-runs them
        after a rollback; recorded progress is the resume point)."""
        if not self.StartAction(None):
            return []
        with self._mu:
            out = [k for k, v in self._wfs.items() if v["status"] != "done"]
        self.EndAction()
        return out

    def workflow_state(self, wf_id: str) -> Optional[dict]:
        if not self.StartAction(None):
            return None
        with self._mu:
            st = self._wfs.get(wf_id)
            st = dict(st) if st is not None else None
        self.EndAction()
        return st
