#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line and raising on failure:

  env      torch / CUDA versions and the card's name and power limit
  build    compile the delta-codec CUDA kernels from src/repro_torch/kernels/csrc
           with nvcc for sm_90a (into build/kernels/)
  kernels  each kernel against its plain PyTorch version on the card, at the
           1-layer gemma-2b stream size (619,526 rows of 1024), f32 and bf16
           inputs: bit-for-bit equality, median time, GB/s, share of the bound
  trainer  gemma-2b at full width with depth cut to 1 layer: data, trainer and
           metrics StateObjects on a LocalCluster; the version-0 base persist,
           two train steps, one forced delta persist (CUDA encode), a trainer
           kill and restore through the delta chain (CUDA decode), one more step
  loop     run_resilient_training at the gemma_2b smoke config on the card:
           trainer and data kills end with the failure-free digest, external
           metrics list every step once, a delta-codec run with a kill
           completes, and the losses follow a CPU run of the same loop

Then it prints the card's name and power limit, a JSON line with each
kernel's numbers, and last {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repository, it fails and prints no
result.
"""
from __future__ import annotations

import os

# cuBLAS needs this before its first handle for deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import dataclasses  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.utils.deterministic  # noqa: E402

HERE = Path(__file__).resolve().parent
RUN_DIR = HERE / "build" / "chip_smoke_run"
#: H100 SXM HBM3 rate and f32 (non-tensor-core) peak, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BLOCK = 1024


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    fn()  # warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
def phase_kernels(nb: int) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    n = nb * BLOCK
    results = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        prev32 = torch.randn(nb, BLOCK, generator=gen, device="cuda")
        new = (prev32 + 0.01 * torch.randn(nb, BLOCK, generator=gen, device="cuda")).to(dt)
        prev = prev32.to(dt)
        del prev32
        codes, scales = ops.delta_encode(new, prev)
        codes_r, scales_r = ref.delta_encode_ref(new, prev)
        torch.cuda.synchronize()
        enc_err = max(float((codes.int() - codes_r.int()).abs().max()),
                      float((scales - scales_r).abs().max()))
        if not (torch.equal(codes, codes_r) and torch.equal(scales, scales_r)):
            raise AssertionError(f"delta_encode {tag}: kernel != plain version "
                                 f"({int((codes != codes_r).sum())} codes, "
                                 f"{int((scales != scales_r).sum())} scales differ)")
        del codes_r, scales_r
        dec = ops.delta_decode(codes, scales, prev, dtype=torch.float32)
        dec_r = ref.delta_decode_ref(codes, scales, prev, dtype=torch.float32)
        dec_err = float((dec - dec_r).abs().max())
        if not torch.equal(dec, dec_r):
            raise AssertionError(f"delta_decode {tag}: kernel != plain version (max {dec_err})")
        del dec, dec_r
        esz = new.element_size()
        enc_bytes = n * (2 * esz + 1) + nb * 4
        dec_bytes = n * (1 + esz + 4) + nb * 4
        timings = {
            "delta_encode": (lambda: ops.delta_encode(new, prev),
                             lambda: ref.delta_encode_ref(new, prev),
                             enc_bytes, 7 * n, enc_err),
            "delta_decode": (lambda: ops.delta_decode(codes, scales, prev, dtype=torch.float32),
                             lambda: ref.delta_decode_ref(codes, scales, prev, dtype=torch.float32),
                             dec_bytes, 2 * n, dec_err),
        }
        for name, (kern, plain, nbytes, nops, err) in timings.items():
            ms = median_ms(kern, 20)
            plain_ms = median_ms(plain, 5)
            b_ms, b_by = bound_ms(nbytes, nops)
            say("kernels", f"{name} ({tag} inputs): bit-for-bit equal to the plain version; "
                f"median {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of the "
                f"{b_by} bound {b_ms:.4f} ms); plain version {plain_ms:.4f} ms")
            results[(name, tag)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                        max_abs_err=err)
        del new, prev, codes, scales
        gc.collect()
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------- #
def _drive_step(cluster, DelayMessage):
    """One data -> trainer -> metrics step, as run_resilient_training drives it."""
    for _ in range(10_000):
        trainer, data, metrics = (cluster.get(k) for k in ("trainer", "data", "metrics"))
        try:
            t_step = trainer.current_step()
            if data.peek_cursor() != t_step:
                data.seek(t_step)
            out = data.next_batch()
            if out is None:
                continue
            step, tokens, hdr = out
            res = trainer.train_on(step, tokens, hdr)
            if res is None:
                cluster.refresh_all()
                continue
            if res[0] == "resync":
                continue
            loss, thdr = res
            metrics.record(step, loss, thdr)
            return step, loss
        except DelayMessage:
            cluster.refresh_all()
    raise RuntimeError("no step completed")


def _wait(pred, what: str, timeout: float) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what} not reached within {timeout} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def phase_trainer(cfg) -> None:
    from repro_torch.checkpoint import DeltaCheckpointCodec, MetricsStateObject, TrainerStateObject
    from repro_torch.core import DelayMessage, LocalCluster
    from repro_torch.data import DataPipelineStateObject, SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_descs
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_flatten

    root = RUN_DIR / "trainer"
    shutil.rmtree(root, ignore_errors=True)
    data = SyntheticLMData(cfg.vocab_size, 4, 16, seed=0)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3))
    codec = DeltaCheckpointCodec(base_every=4)

    def init_state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
        return params, adamw_init(params)

    def flat_params(so):
        return torch.cat([t.reshape(-1).float() for t in tree_flatten(so.params)[0]])

    cluster = LocalCluster(root, group_commit_interval=0.02)
    try:
        cluster.add("data", lambda: DataPipelineStateObject(root / "data", data))
        t0 = time.perf_counter()
        # the trainer persists only when forced: at full width a persist
        # takes minutes on the host (np.savez_compressed)
        cluster.add("trainer", lambda: TrainerStateObject(
            root / "trainer", init_state, step_fn, codec=codec, device="cuda"),
            group_commit_interval=3600.0)
        t_base = time.perf_counter() - t0
        base_t = dict(codec.last_timing)
        cluster.add("metrics", lambda: MetricsStateObject(root / "metrics"))
        trainer = cluster.get("trainer")
        say("trainer", f"{cfg.name} x{cfg.num_layers} layer: "
            f"{sum(t.numel() for t in tree_flatten(trainer.params)[0]):,} parameters; "
            f"version-0 base persist {t_base:.1f} s (device {base_t['device_s']:.2f} s, "
            f"savez {base_t['savez_s']:.1f} s), {trainer.bytes_written:,} B")
        losses = []
        for _ in range(2):
            t0 = time.perf_counter()
            step, loss = _drive_step(cluster, DelayMessage)
            torch.cuda.synchronize()
            losses.append(loss)
            say("trainer", f"step {step}: loss {loss:.6f} ({time.perf_counter() - t0:.2f} s)")
        t0 = time.perf_counter()
        label = trainer.runtime.maybe_persist(force=True)
        t_snap = time.perf_counter() - t0
        enc_t = dict(codec.last_timing)
        t_durable = t_snap + _wait(lambda: trainer.runtime.stats()["committed"] >= label,
                                   "trainer persist durable", 900)
        _wait(lambda: trainer.runtime.boundary.get("trainer", -1) >= label,
              "trainer version in the recovery boundary", 300)
        say("trainer", f"delta persist v{label}: snapshot {t_snap:.1f} s (device encode "
            f"{enc_t['device_s']:.2f} s, savez {enc_t['savez_s']:.1f} s), durable after "
            f"{t_durable:.1f} s")
        pre = flat_params(trainer)

        t0 = time.perf_counter()
        cluster.kill("trainer")
        t_restore = time.perf_counter() - t0
        dec_t = dict(codec.last_timing)
        trainer = cluster.get("trainer")
        if trainer.current_step() != 2:
            raise AssertionError(f"restored step {trainer.current_step()} != 2")
        hdr, body = trainer._split_blob(trainer.store.read(label)[0])
        if hdr["base"] or hdr["prev"] is None:
            raise AssertionError(f"v{label} is not a delta blob: {hdr}")
        if ops.LAUNCHES["delta_encode"] < 1 or ops.LAUNCHES["delta_decode"] < 1:
            raise AssertionError(f"codec did not run through the kernels: {ops.LAUNCHES}")
        scales = torch.from_numpy(np.load(io.BytesIO(body))["scales"]).cuda()
        # codec bound: half a quantisation step of the block, plus the f32
        # rounding of the decoded value (half an ulp, at most 2^-24 |x|)
        err = torch.zeros(scales.numel() * BLOCK, device="cuda")
        err[: pre.numel()] = (flat_params(trainer) - pre).abs() - 2.0 ** -23 * pre.abs()
        worst = float((err.reshape(-1, BLOCK) / (scales[:, None] * 0.51)).max())
        if worst > 1.0:
            raise AssertionError(f"restored params off by {worst:.3f} x the codec bound")
        say("trainer", f"kill + restore through v{hdr['prev']} (base) -> v{label} (delta): "
            f"{t_restore:.1f} s (blob load {dec_t['load_s']:.1f} s, device decode "
            f"{dec_t['device_s']:.3f} s); step 2 restored, params within "
            f"{worst:.3f} x the codec bound of the pre-kill params")
        step, loss = _drive_step(cluster, DelayMessage)
        if step != 2 or not math.isfinite(loss):
            raise AssertionError(f"step after restore: step {step}, loss {loss}")
        say("trainer", f"step {step} after restore: loss {loss:.6f}")
        # the full-width trainer is not persisted again on shutdown
        cluster.kill("trainer", restart=False)
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------- #
def phase_loop(cfg) -> None:
    from repro_torch.kernels import ops
    from repro_torch.train import loop, run_resilient_training
    from repro_torch.tree import tree_map

    steps = 8
    root = RUN_DIR / "loop"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        base = run_resilient_training(root / "base", cfg, steps=steps)
        # the reference: the same loop on the CPU from the same weights (the
        # CPU and CUDA generators draw different streams from one seed)
        init = loop.init_params
        loop.init_params = lambda descs, gen, dtype, device: tree_map(
            lambda t: t.to(device),
            init(descs, torch.Generator(device="cuda").manual_seed(0), dtype, "cuda"))
        try:
            cpu = run_resilient_training(root / "cpu", cfg, steps=steps, device="cpu")
        finally:
            loop.init_params = init
        trainer_kill = run_resilient_training(root / "kt", cfg, steps=steps, kill_trainer_at=4)
        data_kill = run_resilient_training(root / "kd", cfg, steps=steps, kill_data_at=3)
        before = dict(ops.LAUNCHES)
        delta = run_resilient_training(root / "dc", cfg, steps=steps, kill_trainer_at=4,
                                       use_delta_codec=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, res in (("kill_trainer_at=4", trainer_kill), ("kill_data_at=3", data_kill)):
        if res.params_digest != base.params_digest or res.final_step != steps:
            raise AssertionError(f"{name}: digest {res.params_digest} != failure-free "
                                 f"{base.params_digest} (step {res.final_step})")
    if trainer_kill.rollbacks < 1:
        raise AssertionError("the trainer kill caused no rollback")
    ext = sorted(s for s, _ in trainer_kill.external_metrics)
    if ext != list(range(steps)):
        raise AssertionError(f"external metrics not exactly once: {ext}")
    if delta.final_step != steps or len(delta.external_metrics) != steps:
        raise AssertionError(f"delta-codec run incomplete: {delta.final_step}")
    enc = ops.LAUNCHES["delta_encode"] - before["delta_encode"]
    if enc < 1:
        raise AssertionError("the delta-codec run launched no encode kernel")
    got = np.array([l for _, l in base.external_metrics])
    want = np.array([l for _, l in cpu.external_metrics])
    if not np.all(np.isfinite(got)) or got.shape != (steps,):
        raise AssertionError(f"losses {got}")
    # step 0: same weights and batch, f32 sums in another order. Later steps
    # drift: this loop amplifies rounding (the JAX loop against itself, every
    # weight moved by one ulp, differs by 1.5e-3 relative at step 8), so
    # they are held to 5e-3 as in tests/test_torch_training.py
    rel = np.abs(got - want) / np.abs(want)
    if rel[0] > 1e-5 or rel.max() > 5e-3:
        raise AssertionError(f"card vs CPU losses differ: {got} vs {want}")
    say("loop", f"{cfg.name}: failure-free digest {base.params_digest} == trainer-kill and "
        f"data-kill digests; external metrics steps 0..{steps - 1} once each; delta-codec "
        f"run with a kill completed ({enc} encode launches, {delta.checkpoint_bytes:,} B); "
        f"losses {np.round(got, 6).tolist()}, CPU run of the same loop max rel diff "
        f"{rel.max():.2e}; {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import delta_encode as kmod
    from repro_torch.kernels import ops
    from repro_torch.models import param_count, param_descs

    torch.use_deterministic_algorithms(True)
    # every kernel writes all of its outputs (checked against the plain
    # versions below), so torch.empty need not pre-fill them with NaN
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = nvidia_smi()
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); {card}")

    path, secs = kmod.build()
    say("build", f"nvcc {' '.join(kmod.NVCC_FLAGS)}: {path.relative_to(HERE)} "
        + (f"compiled in {secs:.1f} s" if secs else "already built"))

    full = dataclasses.replace(get_config("gemma_2b"), num_layers=1)
    nb = -(-param_count(param_descs(full)) // BLOCK)
    kern = phase_kernels(nb)

    ops.reset_launch_counts()
    phase_trainer(full)
    launches = dict(ops.LAUNCHES)
    say("trainer", f"kernel launches on the main path: {launches}")

    phase_loop(get_config("gemma_2b", smoke=True))

    src = kmod.SOURCE.relative_to(HERE).as_posix()
    replaces = {"delta_encode": "src/repro/kernels/delta_encode.py:24",
                "delta_decode": "src/repro/kernels/delta_encode.py:32"}
    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces[name],
             launches=launches[name], max_abs_err=kern[(name, "f32")]["max_abs_err"],
             ms=kern[(name, "f32")]["ms"], plain_ms=kern[(name, "f32")]["plain_ms"],
             bound_ms=kern[(name, "f32")]["bound_ms"],
             bound_by=kern[(name, "f32")]["bound_by"], library_ms=None)
        for name in ("delta_encode", "delta_decode")
    ]}
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
