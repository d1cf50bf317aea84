"""Speculative serving loop: decode sessions as StateObjects (port of
``repro/train/serve.py``).

The serving counterpart of train/loop.py. Session state (generated tokens +
cursor) is durable-by-DSE: the KV or SSM cache is *derived* state. On
restore the session replays its surviving token prefix through
``decode_step``, one token at a time, to rebuild the cache (cheap relative
to the failure rate, exactly the paper's trade). Responses stream to
clients only behind speculation barriers.

The parameters are shared by every incarnation that ``cluster.kill``
restarts and are never copied (gemma-2b's are 10 GB in f32). The cache is
updated in place by each step (``models/transformer.py``); a session never
keeps an old cache, so the protocol is the reference's. The decode step
runs under ``torch.no_grad()`` on whichever thread calls it: ``Restore``
may run on the runtime's decision-applying thread, so the step sets up
nothing per thread. ``extras`` (the encdec ``"frames"``, the vlm
``"image_embeds"``) go to every ``decode_step``, the replay's too. An
encdec session decodes against its cache's ``enc_out``, which an empty
cache holds as zeros, so its tokens do not depend on ``frames``: the
reference's session behaves so.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import LocalCluster, StateObject, VersionStore
from ..device import resolve_device
from ..models import cache_descs, decode_step, zeros_from_descs
from ..models.config import ModelConfig


class DecodeSessionStateObject(StateObject):
    """Tokens + cursor are the durable truth; the decode cache is derived.

    ``device=None`` runs on the card; pass ``device="cpu"`` for the CPU. The
    parameters must already lie on that device; ``extras`` are moved there."""

    def __init__(self, root: Path, cfg: ModelConfig, params, max_len: int = 64,
                 extras: Optional[dict] = None, device=None) -> None:
        self.device = resolve_device(device)
        super().__init__()
        self.store = VersionStore(root)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.extras = {k: torch.as_tensor(v, device=self.device)
                       for k, v in (extras or {}).items()}
        self.tokens: List[int] = []
        self._cache = self._empty_cache()

    def _empty_cache(self):
        return zeros_from_descs(cache_descs(self.cfg, batch=1, max_len=self.max_len),
                                torch.float32, self.device)

    def _step(self, token: int, index: int) -> torch.Tensor:
        tok = torch.tensor([[token]], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            logits, self._cache = decode_step(self.cfg, self.params, self._cache, tok, index,
                                              extras=self.extras)
        return logits

    def _rebuild_cache(self) -> None:
        """Replay surviving tokens to reconstruct the derived cache."""
        self._cache = self._empty_cache()
        for i, t in enumerate([0] + self.tokens[:-1] if self.tokens else []):
            self._step(t, i)

    # -- persistence -----------------------------------------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        payload = np.asarray(self.tokens, np.int32).tobytes()

        def _io() -> None:
            try:
                self.store.write(version, payload, metadata)
            except RuntimeError:
                return
            callback()

        self.spawn_io(_io)

    def Restore(self, version: int) -> bytes:
        payload, meta = self.store.read(version)
        self.tokens = [int(t) for t in np.frombuffer(payload, np.int32)]
        self._rebuild_cache()
        return meta

    def ListVersions(self):
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        self.store.prune(version)

    def on_crash(self) -> None:
        self.store.poison()
        self.store.drop_memory()
        self.tokens = []
        self._cache = self._empty_cache()

    # -- service API -------------------------------------------------------
    def generate(self, n: int) -> Optional[List[int]]:
        """Speculatively decode ``n`` tokens (one action per token)."""
        out = []
        for _ in range(n):
            if not self.StartAction(None):
                return None
            idx = len(self.tokens)
            if idx >= self.max_len:
                self.EndAction()
                break
            prev = self.tokens[-1] if self.tokens else 0
            logits = self._step(prev, idx)
            t = int(torch.argmax(logits[0, 0, : self.cfg.vocab_size]))
            self.tokens.append(t)
            out.append(t)
            self.EndAction()
        return out

    def stream_durable(self, timeout: float = 30.0) -> Optional[List[int]]:
        """Barrier-gated export: only non-speculative tokens leave."""
        if not self.StartAction(None):
            return None
        if not self.wait_durable(timeout=timeout):
            return None
        out = list(self.tokens)
        self.EndAction()
        return out


@dataclass
class ServeRunResult:
    tokens_generated: int
    durable_tokens: List[int]
    rollbacks: int


def run_speculative_serving(
    root: Path,
    cfg: ModelConfig,
    params,
    *,
    n_tokens: int = 16,
    kill_at: Optional[int] = None,
    group_commit_interval: float = 0.02,
    extras: Optional[dict] = None,
    device=None,
) -> ServeRunResult:
    """``device=None`` runs on the card; pass ``device="cpu"`` (with the
    parameters on the CPU) for the CPU. ``extras`` feed every decode step."""
    dev = resolve_device(device)
    with LocalCluster(root, group_commit_interval=group_commit_interval) as cluster:
        mk = lambda: DecodeSessionStateObject(
            Path(root) / "sess", cfg, params, max_len=max(64, n_tokens + 1), extras=extras,
            device=dev,
        )
        sess = cluster.add("session", mk)
        rollbacks = 0
        produced = 0
        while produced < n_tokens:
            sess = cluster.get("session")
            out = sess.generate(min(4, n_tokens - produced))
            if out is None:
                cluster.refresh_all()
                continue
            produced = len(sess.tokens)
            if kill_at is not None and produced >= kill_at:
                cluster.kill("session")
                kill_at = None
                rollbacks += 1
                produced = len(cluster.get("session").tokens)
        durable = cluster.get("session").stream_durable() or []
        return ServeRunResult(
            tokens_generated=produced,
            durable_tokens=durable,
            rollbacks=rollbacks,
        )
