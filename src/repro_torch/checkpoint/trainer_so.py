"""Trainer / metrics StateObjects over torch training state (port of
``repro/checkpoint/trainer_so.py``; the paper's StateObject abstraction,
DESIGN.md §2 mapping).

TrainerStateObject:
  * one ``train_on`` call = one libDSE action: it consumes the data
    pipeline's header (the batch-lineage edge) and emits a header for
    downstream consumers (metrics/eval/export);
  * ``Persist`` captures a consistent device snapshot (the runtime's
    exclusive epoch guarantees no step interleaves), then writes
    asynchronously — steps keep executing SPECULATIVELY past the
    checkpoint, which is exactly the paper's persistence-off-critical-path;
  * ``Restore`` loads params/opt/step; with the DeltaCheckpointCodec,
    versions between bases are int8 deltas (CUDA delta codec kernels).
    Without it a version is an ``.npz`` of every leaf (``npz.py``): leaves
    with a non-zero bit stored, all-zero ones deflated once per shape.

MetricsStateObject:
  * records (step, loss) under actions that consume trainer headers, so a
    rolled-back step's metric is rolled back with it;
  * ``flush_external`` is barrier-gated — the outside world only ever sees
    metrics that survive any failure (Failure Transparency).

Both record the recorder's (``obs``) spans at the port's own call sites:
``trainer.train_on`` and ``metrics.record`` with their ``dse.start_action``
/ ``dse.end_action`` children, ``trainer.step`` (the step and the wait for
its loss), ``dse.connect``, ``persist.snapshot`` (``persist.d2h``,
``persist.compress``) and ``persist.write`` on the IO thread,
``trainer.on_crash``, ``restore`` (``restore.read``, ``restore.inflate``,
``restore.h2d``); the counters ``persist.raw_bytes``,
``persist.stored_bytes``, ``restore.read_bytes``, ``restore.raw_bytes``, the
plain path's ``persist.leaves_stored``, ``persist.leaves_deflated``,
``persist.members_reused`` and ``restore.members_reused``, and
``dse.refresh_ns`` / ``dse.refresh_rounds`` on the background refresher.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.ids import Header
from ..core.state_object import StateObject, VersionStore
from ..device import resolve_device
from ..tree import tree_flatten, tree_unflatten
from . import npz
from .delta import DeltaCheckpointCodec, _flatten

#: the thread of ``LocalCluster``'s background Refresh rounds
REFRESHER = "dse-refresher"


def _refresh(so: StateObject) -> None:
    """``so``'s Refresh; on the background refresher, timed and counted."""
    if not (obs.enabled() and threading.current_thread().name == REFRESHER):
        StateObject.Refresh(so)
        return
    t0 = time.perf_counter_ns()
    try:
        StateObject.Refresh(so)
    finally:
        obs.add_ns("dse.refresh_ns", time.perf_counter_ns() - t0)
        obs.count("dse.refresh_rounds")


class TrainerStateObject(StateObject):
    def __init__(
        self,
        root: Path,
        init_state_fn: Callable[[], Tuple],   # () -> (params, opt_state)
        step_fn: Callable,                    # (params, opt, batch) -> (params, opt, loss)
        codec: Optional[DeltaCheckpointCodec] = None,
        device=None,
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.store = VersionStore(root, keep_in_memory=4)
        self.params, self.opt_state = init_state_fn()
        self._init_state_fn = init_state_fn
        self.step_fn = step_fn
        self.step = 0
        # loss history is part of trainer state: it rolls back and replays
        # atomically with params/step (exactly-once metrics reconciliation)
        self.loss_history: List[Tuple[int, float]] = []
        self.codec = codec
        self._prev_flat: Optional[torch.Tensor] = None   # on the device
        self._last_label: Optional[int] = None
        self._since_base = 0
        self._chain: Dict[int, bytes] = {}   # version -> blob (delta mode)
        self._shapes = None
        self._treedef = None
        self._mu = threading.Lock()
        self.bytes_written = 0

    # -- persistence ---------------------------------------------------------
    def _snapshot_blob(self, version: int) -> bytes:
        state = (self.params, self.opt_state)
        prev_label = None
        if self.codec is not None:
            # chain bookkeeping: a delta's parent is the LAST PERSISTED label
            # of this incarnation's lineage. Walking explicit parent pointers
            # at restore time is immune to stale blobs from rolled-back
            # incarnations that share label ranges (DESIGN.md §2 gaps).
            force_base = (
                self._prev_flat is None
                or self._since_base >= self.codec.base_every
            )
            blob, self._prev_flat = self.codec.encode(
                version, state, None if force_base else self._prev_flat
            )
            body = [blob]
            prev_label = None if force_base else self._last_label
            self._since_base = 0 if force_base else self._since_base + 1
            self._last_label = version
            is_base = force_base
        else:
            leaves, _ = tree_flatten(state)
            with obs.span("persist.d2h"):
                members = npz.to_host(leaves)
            with obs.span("persist.compress"):
                packed = npz.pack(members)
            del members
            obs.count("persist.leaves_stored", packed.stored)
            obs.count("persist.leaves_deflated", packed.deflated)
            obs.count("persist.members_reused", packed.reused)
            body = packed.parts
            is_base = True
        hdr = json.dumps({
            "step": self.step, "history": self.loss_history,
            "prev": prev_label, "base": is_base,
        }).encode()
        # spaces after the JSON put the body at a multiple of 64 bytes, so
        # the stored leaves are read in place, aligned
        hdr += b" " * (-(4 + len(hdr)) % 64)
        return b"".join([len(hdr).to_bytes(4, "little"), hdr, *body])

    @staticmethod
    def _split_blob(blob: bytes):
        """(header, body); the body a view of ``blob``, not a copy."""
        n = int.from_bytes(blob[:4], "little")
        hdr = json.loads(blob[4 : 4 + n].decode())
        return hdr, memoryview(blob)[4 + n :]

    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        # Snapshot must be consistent: runtime holds the exclusive epoch, so
        # no train action is in flight. The host copies wait for queued steps.
        with obs.span("persist.snapshot", version=version) as snap:
            blob = self._snapshot_blob(version)
        if obs.enabled():
            obs.count("persist.raw_bytes", sum(t.numel() * t.element_size() for t in
                                               tree_flatten((self.params, self.opt_state))[0]))
            obs.count("persist.stored_bytes", len(blob))
        if self.codec is not None:
            self._chain[version] = blob

        def _io() -> None:
            with obs.span("persist.write", parent=snap):
                try:
                    self.store.write(version, blob, metadata)
                except RuntimeError:
                    return
            self.bytes_written += len(blob)
            callback()

        self.spawn_io(_io)

    def Connect(self, config) -> None:
        # the version-0 persist of a fresh incarnation, or the restore of a
        # restarted one, runs inside
        with obs.span("dse.connect") as s:
            super().Connect(config)
            s.tag(world=self.runtime.world)

    def Refresh(self) -> None:
        _refresh(self)

    def Restore(self, version: int) -> bytes:
        with obs.span("restore", world=self.runtime.world, version=version):
            return self._restore(version)

    def _restore(self, version: int) -> bytes:
        with obs.span("restore.read"):
            payload, meta = self.store.read(version)
        obs.count("restore.read_bytes", len(payload))
        hdr, body = self._split_blob(payload)
        if self.codec is not None:
            # walk explicit parent pointers down to a base (stale blobs from
            # rolled-back label ranges are never visited)
            bodies: List[bytes] = []
            v = version
            while True:
                blob = self._chain.get(v)
                if blob is None:
                    with obs.span("restore.read"):
                        blob, _ = self.store.read(v)
                h, b = self._split_blob(blob)
                bodies.append(b)
                if h.get("base", True) or h.get("prev") is None:
                    break
                v = int(h["prev"])
            bodies.reverse()
            _, p_shapes, p_treedef = _flatten(self.params)
            _, o_shapes, o_treedef = _flatten(self.opt_state)
            state, flat = self.codec.decode_chain(
                bodies, p_shapes, p_treedef, o_shapes, o_treedef, self.device
            )
            self._prev_flat = flat
            self._last_label = version
            self._since_base = 0  # force a fresh base on the next persist
        else:
            z = npz.Reader(body)
            _, treedef = tree_flatten((self.params, self.opt_state))

            def leaf(i: int) -> torch.Tensor:
                # one leaf read (a stored one in place) and copied at a time
                with obs.span("restore.inflate"):
                    a = z.array(i)
                obs.count("restore.raw_bytes", a.nbytes)
                with obs.span("restore.h2d"):
                    return npz.to_device(a, self.device)

            state = tree_unflatten(treedef, [leaf(i) for i in range(len(z))])
            obs.count("restore.members_reused", z.reused)
        self.params, self.opt_state = state
        self.step = int(hdr["step"])
        self.loss_history = [tuple(r) for r in hdr["history"]]
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        # keep delta-chain bases: prune only below the last base <= version
        if self.codec is not None:
            return  # simple policy: delta mode retains history (bounded runs)
        self.store.prune(version)

    def on_crash(self) -> None:
        with obs.span("trainer.on_crash", crashed_world=self.runtime.world):
            self.store.poison()
            self.store.drop_memory()
            self._chain = {}
            self._prev_flat = None
            self._last_label = None
            self._since_base = 0
            self.params, self.opt_state = self._init_state_fn()
            self.step = 0
            self.loss_history = []

    # -- service API -----------------------------------------------------------
    def train_on(self, step: int, tokens: np.ndarray, header: Optional[Header] = None,
                 extras: Optional[dict] = None):
        """One speculative train step. Returns (loss, header) or None."""
        with obs.span("trainer.train_on", step=step):
            with obs.span("dse.start_action"):
                started = self.StartAction(header)
            if not started:
                return None
            if step != self.step:
                # stale/duplicate batch relative to restored state: refuse inside
                # the action so the driver resyncs the cursor.
                with obs.span("dse.end_action"):
                    self.EndAction()
                return ("resync", self.step)
            batch = {"tokens": tokens, **(extras or {})}
            # the step's self time is the host's wait for the loss
            with obs.span("trainer.step"):
                self.params, self.opt_state, loss = self.step_fn(
                    self.params, self.opt_state, batch
                )
                loss = float(loss)
            self.loss_history.append((self.step, loss))
            self.step += 1
            with obs.span("dse.end_action"):
                return loss, self.EndAction()

    def current_step(self) -> int:
        return self.step

    def history_snapshot(self):
        """(history, header) under an action — for metrics reconciliation
        after a rollback dropped records the trainer state still covers."""
        if not self.StartAction(None):
            return None
        out = list(self.loss_history)
        return out, self.EndAction()

    def params_digest(self) -> str:
        import hashlib

        flat, _, _ = _flatten(self.params)
        return hashlib.sha256(np.ascontiguousarray(flat.cpu().numpy())).hexdigest()[:16]


class MetricsStateObject(StateObject):
    def __init__(self, root: Path) -> None:
        super().__init__()
        self.store = VersionStore(root)
        self.records: List[Tuple[int, float]] = []
        self._mu = threading.Lock()

    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        with self._mu:
            payload = json.dumps(self.records).encode()

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
            self.records = [tuple(r) for r in json.loads(payload.decode())]
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        self.store.prune(version)

    def on_crash(self) -> None:
        self.store.poison()
        self.store.drop_memory()
        with self._mu:
            self.records = []

    def Refresh(self) -> None:
        _refresh(self)

    def record(self, step: int, loss: float, header: Optional[Header] = None) -> bool:
        with obs.span("metrics.record", step=step):
            with obs.span("dse.start_action"):
                started = self.StartAction(header)
            if not started:
                return False
            with self._mu:
                self.records.append((step, loss))
            with obs.span("dse.end_action"):
                self.EndAction()
            return True

    def flush_external(self, timeout: float = 30.0) -> List[Tuple[int, float]]:
        """Barrier-gated export: returns only non-speculative metrics."""
        if not self.StartAction(None):
            return []
        t = self.Detach()
        t.Barrier(timeout=timeout)
        if not self.Merge(t):
            return []
        with self._mu:
            out = list(self.records)
        self.EndAction()
        return out
