"""Resilient training loop under DSE (port of ``repro/train/loop.py``) —
the paper's durable-execution abstraction applied to a torch training job
on the card (DESIGN.md §2).

The driver composes three StateObjects:
    data  (stream cursor)  --header-->  trainer  --header-->  metrics

Every train step runs SPECULATIVELY: persistence happens in the background
at the group-commit cadence; failures roll the affected components back to
the consistent prefix and the driver resumes from the trainer's restored
step (control flow is part of persisted state). Externally-visible metrics
are barrier-gated. With a deterministic data pipeline, a run with failures
produces bit-identical parameters to a failure-free run — that is the
determinism test in tests/test_training.py and its twin
tests/test_torch_training.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from ..checkpoint import DeltaCheckpointCodec, MetricsStateObject, TrainerStateObject
from ..core import DelayMessage, LocalCluster
from ..data import DataPipelineStateObject, SyntheticLMData
from ..device import resolve_device
from ..models import init_params, param_descs
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from ..launch.steps import make_train_step


@dataclass
class TrainRunResult:
    steps_run: int
    final_step: int
    params_digest: str
    metrics: List[Tuple[int, float]]
    external_metrics: List[Tuple[int, float]]
    rollbacks: int
    checkpoint_bytes: int


def run_resilient_training(
    root: Path,
    cfg: ModelConfig,
    *,
    steps: int = 20,
    global_batch: int = 4,
    seq_len: int = 16,
    kill_trainer_at: Optional[int] = None,
    kill_data_at: Optional[int] = None,
    group_commit_interval: float = 0.02,
    use_delta_codec: bool = False,
    seed: int = 0,
    lr: float = 1e-3,
    device=None,
) -> TrainRunResult:
    """``device=None`` runs on the card; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    data = SyntheticLMData(cfg.vocab_size, global_batch, seq_len, seed=seed)
    opt_cfg = AdamWConfig(lr=lr)
    step_fn = make_train_step(cfg, opt_cfg, remat="none")

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(param_descs(cfg), gen, dtype=torch.float32, device=dev)
        return params, adamw_init(params)

    codec = DeltaCheckpointCodec(base_every=4) if use_delta_codec else None

    with LocalCluster(root, group_commit_interval=group_commit_interval) as cluster:
        data_so = cluster.add(
            "data", lambda: DataPipelineStateObject(Path(root) / "data", data)
        )
        trainer = cluster.add(
            "trainer",
            lambda: TrainerStateObject(
                Path(root) / "trainer", init_state, step_fn, codec=codec, device=dev
            ),
        )
        metrics = cluster.add("metrics", lambda: MetricsStateObject(Path(root) / "metrics"))

        rollbacks = 0
        steps_run = 0
        last_world = 0
        while True:
            trainer = cluster.get("trainer")
            data_so = cluster.get("data")
            metrics = cluster.get("metrics")
            if trainer.runtime.world > last_world:  # a recovery happened
                rollbacks += trainer.runtime.world - last_world
                last_world = trainer.runtime.world
            t_step = trainer.current_step()
            if t_step >= steps:
                break

            try:
                if data_so.peek_cursor() != t_step:
                    data_so.seek(t_step)  # resync after rollback/restart
                    # reconcile metrics: a rollback may have dropped records
                    # for steps the trainer's restored state still covers (the
                    # paper's conservative over-rollback, §5.3); re-record
                    # from the trainer's own persisted loss history.
                    snap = trainer.history_snapshot()
                    if snap is not None:
                        history, hh = snap
                        have = {s for s, _ in metrics.records}
                        for s, l in history:
                            if s not in have:
                                metrics.record(s, l, hh)

                out = data_so.next_batch()
                if out is None:
                    continue
                step, tokens, hdr = out
                res = trainer.train_on(step, tokens, hdr)
                if res is None:
                    # stale cross-epoch message: let the refresher deliver
                    # the decision instead of spinning
                    cluster.refresh_all()
                    continue
                if isinstance(res, tuple) and res[0] == "resync":
                    continue
                loss, thdr = res
                steps_run += 1
                metrics.record(step, loss, thdr)
            except DelayMessage:
                # cross-epoch message (Def 4.3): let lagging components apply
                # pending decisions, then retry the iteration.
                cluster.refresh_all()
                continue

            if kill_trainer_at is not None and step + 1 == kill_trainer_at:
                cluster.kill("trainer")
                kill_trainer_at = None  # counted via the world watermark
            if kill_data_at is not None and step + 1 == kill_data_at:
                cluster.kill("data")
                kill_data_at = None

        # force final durability, reconcile any metric dropped by a late
        # rollback (the refresher applies decisions asynchronously), then
        # export only non-speculative metrics
        trainer = cluster.get("trainer")
        metrics = cluster.get("metrics")
        trainer.runtime.maybe_persist(force=True)
        snap = trainer.history_snapshot()
        if snap is not None:
            history, hh = snap
            have = {s for s, _ in metrics.records}
            for s, l in history:
                if s not in have:
                    metrics.record(s, l, hh)
        external = metrics.flush_external()
        recorded = list(metrics.records)

        return TrainRunResult(
            steps_run=steps_run,
            final_step=trainer.current_step(),
            params_digest=trainer.params_digest(),
            metrics=recorded,
            external_metrics=external,
            rollbacks=rollbacks,
            checkpoint_bytes=trainer.bytes_written,
        )
