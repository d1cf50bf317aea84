#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line and raising on failure:

  env      torch / CUDA versions and the card's name and power limit
  build    compile the three CUDA sources of src/repro_torch/kernels/csrc
           (delta codec, SSD, flash attention) with nvcc for sm_90a, one nvcc
           per source, all started together (into build/kernels/); print each
           kernel function's registers and spill bytes from ptxas (the SSD
           source has five: chunk state and chunk scan in f32 and bf16, and
           the state passing), and its count of tensor-core (HMMA)
           instructions in the SASS
  kernels  each delta-codec kernel against its plain PyTorch version on the
           card, at the 1-layer gemma-2b stream size (619,526 rows of 1024),
           f32 and bf16 inputs: bit-for-bit equality, median time, GB/s,
           share of the bound
  ssd      the SSD kernels against the sequential recurrence ssd_ref at the
           full-width mixer shape of mamba2-370m (x (4, 2048, 32, 64), B/C
           (4, 2048, 1, 128), chunk 256), f32 and bf16: error within 1e-4 /
           5e-2, two calls bit-identical, median time, share of the bound,
           the device time of each of the call's three kernels
           (torch.profiler), the plain time, and the time of the model's own
           chunked composition models.ssm.ssd_chunked on the same inputs
  ssm      mamba2-370m at full width (48 layers, batch 4 x 2048, f32, seeded
           random weights): forward_ssm (the model's chunked path), then the
           same layers with every mixer on ssd_impl=ops.ssd_model_impl; the
           SSD kernels are called exactly 48 times and the logits agree;
           the median of 3 warmed forwards of each route, and the device
           time of each route's kernels by name from torch.profiler (the SSD
           kernels' own time per forward among them)
  flash    ops.flash_attention at gemma-2b's attention shape (q (4, 2048, 8,
           256), k/v (4, 2048, 1, 256)), causal and non-causal, f32 (FP32 FMA)
           and bf16 (tensor cores), against flash_attention_ref over the
           repeated kv heads (2e-5 / 2e-2); median time beside the plain
           version and torch.nn.functional.scaled_dot_product_attention (the
           yardstick only: the port never calls it) and the backend SDPA took
  trainer  gemma-2b at full width with depth cut to 1 layer: data, trainer and
           metrics StateObjects on a LocalCluster; the version-0 base persist,
           two train steps, one forced delta persist (CUDA encode), a trainer
           kill and restore through the delta chain (CUDA decode), one more step
  loop     run_resilient_training at the gemma_2b smoke config on the card:
           trainer and data kills end with the failure-free digest, external
           metrics list every step once, a delta-codec run with a kill
           completes, and the losses follow a CPU run of the same loop. Then
           the mamba2_370m smoke config (the ssm family): a trainer kill ends
           with the failure-free digest; with the delta codec (whose restore
           is lossy, so no digest is claimed) a failure-free run and a run
           with a trainer kill complete, list every step once, launch the
           codec kernels, and their losses agree. Then the granite-moe,
           deepseek-v2-lite and zamba2 smoke configs (moe, mla, hybrid): a
           trainer kill ends with the failure-free digest, and the external
           metrics list every step once (the encdec and vlm families are not
           run here: the loop feeds no frames or image embeddings, and its
           train step raises KeyError, as the reference's does)
  fabric   run_resilient_training at the gemma_2b smoke config over the
           port's fabric (repro_torch.net): for each run the loop module's
           LocalCluster is replaced by a NetCluster over a new SimTransport
           (FABRIC_LINK: 1 ms +- 0.5 latency, 5% loss, reordering and
           duplication on every link) with FABRIC_SHARDS coordinator shards,
           under the dse and the durable runtime, each with a trainer kill:
           the digest equals the loop phase's failure-free LocalCluster
           run's, the external metrics list every step once; each run's
           seconds beside the LocalCluster kill run's, its rollbacks and
           the transport's counts; no kernel launched (no codec). Then the
           17 pinned seeds of tests/scenarios/regression_seeds.json through
           repro_torch.sim.explore.run_one (deterministic simulation, host
           only): each one's events and virtual time, its invariants green
  train_full  one make_train_step of mamba2-370m at full width (421,709,312
           parameters) on 1 x 2048 tokens, f32, under remat "none" and
           "full" from the same state, in turns: median step time and peak
           memory of each; losses and new params of the two within 1e-6 of
           max |param| (bit-identity printed); two calls under one policy
           bit-identical. Then granite-moe at full width and 12 of its 32
           layers (TRAIN_MOE_LAYERS) under remat "full": step time, peak
           memory, two calls bit-identical. Then seamless-m4t-large-v2 at
           full width and TRAIN_ENCDEC_LAYERS encoder and decoder layers on
           1 x 2048 tokens and 1 x 1024 seeded frames, under remat "full",
           likewise
  prefill  make_prefill_step at 1 x 2048 tokens, f32, on yi-6b, glm4-9b,
           gemma3-4b, granite-moe, deepseek-v2-lite, zamba2, seamless (1 x 1024
           frames) and llama-3.2-vision at its first VLM_GROUPS groups (1024
           image tokens; the gates set non-zero) at full width, one model at
           a time: median of 3 warmed calls, achieved TFLOP/s
           against the f32 peak (operations by the reference's algorithm,
           _prefill_flops); the last-position logits equal the full forward's
           last row within 1e-5 of max |logit|
  ep       granite-moe at full width through Tuning.moe_impl="ep" (the
           index-based dispatch of parallel/ep_moe.py) on a world-of-one
           NCCL mesh (file:// rendezvous in a temporary directory), against
           the einsum dispatch: one MoE layer at 1 x 2048 tokens (same
           capacity and drop order: EP_LAYER_TOL), median ms of each and the
           EP route's device time by kernel; its gradients through
           compress_gradients_int8, two steps, bit-equal to the CPU's; the
           prefill at x32 timed both ways (TFLOP/s at _prefill_flops and at
           EP's own count), held in float64 at the first
           SERVE_CHECK_CUT layers (the random model is chaotic in f32 and,
           at 32 layers, in float64); one train step at TRAIN_MOE_LAYERS
           under remat "full": loss within EP_LOSS_TOL of the einsum
           step's, two EP steps bit-identical
  serve    the speculative serving path (models decode_step, train/serve.py)
           at full width: gemma-2b x18, gemma3-4b x34, mamba2-370m x48,
           granite-moe x32, deepseek-v2-lite x27, zamba2 x38, seamless x24
           (its decode primed with the encoder output) and llama-3.2-vision
           at its first VLM_GROUPS groups, f32, seeded random weights and
           extras, batch 1: the median decode ms per token against
           the batch-1 HBM bound (weight bytes over 3.35 TB/s; for MoE the
           active-expert bound beside it; for encdec and vlm the larger of
           the weights a step reads and the cross-attention K/V it projects
           again over the f32 peak); device time, launches and idle
           share of SERVE_PROFILED warmed steps (torch.profiler); a
           16-token serving run failure-free and with kill_at=8 give the
           same durable tokens,
           with the seconds Restore took to replay; gemma-2b's decode timed
           with Tuning.decode_seq_constraint off and on, in turns; then
           teacher-forced decode_step against one forward over 64 / 256
           tokens (1e-4 / 1e-3 of max |logit|; the checks of the families
           with attention in float64, see SERVE_TOL and SERVE_CHECK_CUT; MoE
           at a capacity that drops no slot, _held). The f32 decode that is
           timed runs SERVE_TIMED steps where its result is printed, not
           held (the families checked in float64). At the smoke configs
           of the ten architectures the tokens served on the card equal a
           CPU run's from the same weights and extras (gemma3's 24 tokens
           wrap its window-8 rings). The serving path launches none of the
           kernels above
  dryrun   the multi-pod dry run on the production mesh, in one
           subprocess that runs the CLI (``repro_torch.launch.dryrun``,
           --mesh single) on DRYRUN_CELLS: gemma-2b train_4k, mamba2-370m
           prefill_32k (the cell whose plan lay furthest from GSPMD's) and gemma-2b
           train_4k under --constrain-activations (fake CUDA tensors as
           DTensors over a 256-rank fake process group; nothing allocated,
           no kernel launched): each record's status (must be "ok"), its
           three roofline terms, per-card flops, all-gathers and wire bytes
           beside the figures of the earlier planner (DRYRUN_BEFORE), the seconds
           its trace took, and the kernel launches the subprocess counted
           over each cell (the dryrun path's counts, all 0, checked).
           Then the counter's calibration on the card: OpCounter over
           yi-6b's make_prefill_step at 1 x 2048
           tokens, f32, on plain tensors (a world of one): its dot TFLOP
           beside _prefill_flops' analytic count, the roofline time of its
           counts at the f32 peak and the HBM rate, and the measured
           prefill ms (median of 3 warmed calls); no limit on the ratio;
           its launches are the dryrun_calibration path's

Then it prints the card's name and power limit, a JSON line with each
kernel's numbers (at f32 inputs, and SSD and flash attention at bf16 too;
each entry names its dtype; ``launches`` counts the run of the path the
kernel was ported for (the codec: trainer; SSD: ssm; flash attention: flash)
and ``path_launches`` every path's run, each read after its counts were set
to 0), and last {"ok": true, "device": {...}}. Without a CUDA
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
import re  # noqa: E402
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
sys.path.insert(0, str(HERE / "src"))

from repro_torch.launch.mesh import H100_SXM  # noqa: E402

#: H100 SXM HBM3 rate, f32 (non-tensor-core) and dense bf16 tensor-core
#: peaks (NVIDIA's data sheet, by way of launch/mesh.py)
HBM_BYTES_PER_S = H100_SXM["hbm_bw"]
F32_OPS_PER_S = H100_SXM["peak_flops_f32"]
BF16_OPS_PER_S = H100_SXM["peak_flops_bf16"]
BLOCK = 1024
#: mamba2-370m at full width: batch x sequence of the ssd and ssm phases
SSM_BATCH, SSM_SEQ = 4, 2048
#: gemma-2b's attention: batch x sequence of the flash phase
FLASH_BATCH, FLASH_SEQ = 4, 2048
#: the kernel-route logits against forward_ssm's, relative to max |logit|.
#: Both routes take f32 exp(cum_i - cum_j) of decay sums that reach a few
#: hundred within a 256 chunk, and 48 layers amplify the rounding: the two
#: differ by about 3e-4 on an H100 (PERF.md, examples/torch_ssd_drift.py)
SSM_TOL = 1e-3
#: tokens of the train_full and prefill phases (batch 1)
TRAIN_SEQ = PREFILL_SEQ = 2048
#: the moe, mla and hybrid architectures (their smoke configs in the loop
#: phase, full width in prefill and serve)
NEW_FAMILIES = ("granite_moe_3b_a800m", "deepseek_v2_lite_16b", "zamba2_1p2b")
#: granite-moe's depth in train_full: the functional AdamW holds params,
#: grads, both moments and the new params and moments at once (28 bytes a
#: parameter in f32, and its temporaries for the largest leaf, the stacked
#: experts), so the 32 layers' 3.38e9 parameters (95 GB) do not fit the
#: card, nor do 16 (1.77e9: out of memory on an H100 in adamw_update, beside
#: the first call's params that the second is compared with); 12 (1.37e9) do
TRAIN_MOE_LAYERS = 12
#: the encdec and vlm architectures: full width in prefill and serve (the
#: vlm cut in depth, VLM_GROUPS), their smoke configs in the serve phase's
#: card-vs-CPU check, seamless's train step in train_full
CROSS_FAMILIES = ("seamless_m4t_large_v2", "llama_3p2_vision_90b")
#: llama-3.2-vision-90b's depth on the card: its 87,679,377,448 parameters
#: (351 GB in f32) do not fit one H100, so prefill and serving run its first
#: 2 of 20 groups: 10 of 100 layers, 8 self and 2 gated cross (42.7 GB)
VLM_GROUPS = 2
#: seamless's depth in train_full, its encoder and decoder cut alike: the
#: functional AdamW holds 28 bytes a parameter, and the whole model's 2.04e9
#: parameters (57 GB), beside the activations and the first call's params
#: that the second is compared with, do not fit the card (24 + 24 ran out of
#: memory on an H100 in adamw_update); 16 + 16 (1.54e9) do
TRAIN_ENCDEC_LAYERS = 16


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


def bound_ms(nbytes: int, ops: int, peak: float = F32_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def on_card(name: str):
    """An architecture's config as the card runs it: full width, and
    llama-3.2-vision cut to its first VLM_GROUPS groups (see there)."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, num_layers=VLM_GROUPS * cfg.cross_attn_period)
    return cfg


def depth(cfg) -> str:
    if cfg.family == "encdec":
        return f"x{cfg.encoder_layers} encoder + x{cfg.num_layers} decoder"
    return f"x{cfg.num_layers}"


def extras_for(cfg, gen) -> dict:
    """Seeded stub frames (encdec, (1, source_len, D)) or image embeddings
    (vlm, (1, num_image_tokens, D)) on the generator's
    device, f32, of the std of an embedded token: rows of std
    1/sqrt(vocab_padded) (the init's fan-in), times sqrt(d_model) under
    gelu. Nothing is drawn for the other families."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    key, n = (("frames", cfg.source_len) if cfg.family == "encdec"
              else ("image_embeds", cfg.num_image_tokens))
    std = math.sqrt((cfg.d_model if cfg.activation == "gelu" else 1) / cfg.vocab_padded)
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=gen.device)
    return {key: x * std}


def open_gates(cfg, params, gen) -> None:
    """A vlm's cross-block gates are 0 at init, which makes each cross block
    the identity: set them in place to seeded values of magnitude 0.5-1.5 and
    random sign. Nothing is drawn for the other families."""
    if cfg.family != "vlm":
        return
    gcross = params["group_cross"]
    for holder, key in ((gcross["attn"], "gate"), (gcross, "mlp_gate")):
        t = holder[key]
        mag = torch.rand(t.shape, generator=gen, device=t.device) + 0.5
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device) * 2 - 1
        holder[key] = (mag * sign).to(t.dtype)


def to_dtype(tree, dtype) -> None:
    """Every leaf of a nested dict to ``dtype``, in place, one at a time:
    each old leaf is freed before the next new one is made, so a float64
    copy needs little more than its own memory."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            to_dtype(tree[k], dtype)
        else:
            tree[k] = tree[k].to(dtype)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """|got - want| <= tol + tol |want| everywhere (numpy's allclose with
    atol = rtol = tol, as tests/test_kernels.py); returns max |got - want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(got).all()) or bool((diff > tol + tol * want.abs()).any()):
        raise AssertionError(f"{name}: kernel != plain version (max abs err {err}, tol {tol})")
    return err


def _demangle(names: list) -> dict:
    """Mangled -> readable C++ names through c++filt, where the toolkit's
    machine has it (the names stay mangled otherwise)."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) != len(names):
        return {n: n for n in names}
    return {n: d.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for n, d in zip(names, lines)}


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill-store bytes, spill-load bytes) for each entry
    function in an ``nvcc -Xptxas=-v`` log (kernels/build.py writes it beside
    the library)."""
    rows, fn, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            fn, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", ln)) and fn is not None:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    names = _demangle([r[0] for r in rows])
    return [(names[r[0]], *r[1:]) for r in rows]


def sass_counts(lib: Path, opcode: str) -> dict:
    """Instructions whose opcode starts with ``opcode`` in each kernel of the
    library's SASS (cuobjdump from the CUDA toolkit; empty without it)."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True)
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        if m := re.match(r"\s*Function : (\S+)", ln):
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\*/\s+" + opcode + r"\b", ln):
            counts[fn] += 1
    names = _demangle(list(counts))
    return {names[k]: c for k, c in counts.items()}


def profile(fn) -> list:
    """torch.profiler's per-operator averages of one synchronised run of
    ``fn`` on the card (host operators and device kernels). The tracer has
    now and then handed back a trace without a single device kernel (one
    of the ssd phase's profiles, on an H100 with torch 2.11): such a trace
    is taken once more, and ``by_name`` fails if the second is empty too."""
    from torch.profiler import ProfilerActivity, profile as _profile

    for attempt in range(2):
        torch.cuda.synchronize()
        with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        try:
            by_name(events, device=True)
            return events
        except AssertionError:
            say("profile", f"torch.profiler recorded no device time (attempt {attempt + 1})")
    return events


def by_name(events, device: bool) -> dict:
    """(self time in ms, count) by name: of the CUDA kernels (``device``),
    or of the host operators."""
    from torch.autograd import DeviceType

    out = {}
    for ev in events:
        if (ev.device_type == DeviceType.CUDA) != device:
            continue
        if device:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
        else:
            us = ev.self_cpu_time_total
        if us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + us / 1e3, n + ev.count)
    if device and not out:
        raise AssertionError("torch.profiler recorded no device time on the card")
    return out


def device_ms_by_kernel(fn) -> dict:
    """Device time (ms) of each CUDA kernel that one run of ``fn`` launches,
    by name, from torch.profiler's trace of the card."""
    return {k: ms for k, (ms, _) in by_name(profile(fn), device=True).items()}


def _ssd_kernel_ms(by_kernel: dict) -> dict:
    return {k.split("(")[0]: v for k, v in by_kernel.items()
            if "ssd_chunk_" in k or "ssd_state_passing" in k}


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
def _ssd_inputs(gen, h: int, p: int, n: int, dt_type):
    """The recipe of tests/test_kernels.py:72-81 at the full-width shape."""
    b, s = SSM_BATCH, SSM_SEQ
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dt_type)
    dt = (torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
          * 0.1).to(dt_type)
    A = -torch.exp(torch.randn(h, generator=gen, device="cuda") * 0.3)
    Bm = (torch.randn(b, s, 1, n, generator=gen, device="cuda") * 0.5).to(dt_type)
    Cm = (torch.randn(b, s, 1, n, generator=gen, device="cuda") * 0.5).to(dt_type)
    return x, dt, A, Bm, Cm


def phase_ssd(cfg) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import ssd_chunked

    s_cfg = cfg.ssm
    h, p, n, L = s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.d_state, s_cfg.chunk_size
    b, s = SSM_BATCH, SSM_SEQ
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for dt_type, tag, tol, peak in ((torch.float32, "f32", 1e-4, F32_OPS_PER_S),
                                    (torch.bfloat16, "bf16", 5e-2, BF16_OPS_PER_S)):
        x, dt, A, Bm, Cm = _ssd_inputs(gen, h, p, n, dt_type)
        y = ops.ssd(x, dt, A, Bm, Cm, chunk=L)
        torch.cuda.synchronize()
        err = check_close(f"ssd {tag}", y, ref.ssd_ref(x, dt, A, Bm, Cm, L), tol)
        if not torch.equal(y, ops.ssd(x, dt, A, Bm, Cm, chunk=L)):
            raise AssertionError(f"ssd {tag}: two calls on the same inputs differ")
        ms = median_ms(lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=L), 10)
        split = _ssd_kernel_ms(device_ms_by_kernel(lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=L)))
        plain_ms = median_ms(lambda: ref.ssd_ref(x, dt, A, Bm, Cm, L), 3)
        chunked_ms = median_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk=L), 10)
        # products and sums the chunked algorithm needs: the intra-chunk
        # pairs j <= i (C.B over N, then the gate times x over P), C.state
        # and the state update (2 L N P each), per (batch, head, chunk)
        tri = L * (L + 1) // 2
        nops = b * h * (s // L) * (2 * tri * (n + p) + 4 * L * n * p)
        esz = x.element_size()
        nbytes = esz * (2 * x.numel() + Bm.numel() + Cm.numel() + dt.numel()) + 4 * A.numel()
        b_ms, b_by = bound_ms(nbytes, nops, peak)
        say("ssd", f"{tag}: within {tol} of ssd_ref (max abs err {err:.3e}), two calls "
            f"bit-identical; median {ms:.4f} ms ({nops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} "
            f"of the {b_by} bound {b_ms:.4f} ms); device time by kernel "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
            + f"; plain version {plain_ms:.1f} ms; models.ssm.ssd_chunked {chunked_ms:.4f} ms "
            f"(kernel / chunked {ms / chunked_ms:.3f}x); no library call: no single PyTorch "
            f"call computes the SSD recurrence")
        results[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            max_abs_err=err, chunked_ms=chunked_ms, split=split)
        del x, dt, A, Bm, Cm, y
    gc.collect()
    torch.cuda.empty_cache()
    return results


def phase_ssm(cfg) -> dict:
    """Path (A): the forward of mamba2-370m at full width, once on the
    model's chunked SSD and once with every mixer on the SSD kernel. Returns
    every kernel's launches on the kernel route."""
    from repro_torch.kernels import ops
    from repro_torch.models import apply_head, forward_ssm, init_params, param_count, param_descs
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.ssm import mamba2_mixer
    from repro_torch.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_SEQ), generator=gen, device="cuda")

    def kernel_route():
        x = params["embed"][tokens]
        for i in range(cfg.num_layers):
            lp = tree_map(lambda w: w[i], params["layers"])
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, _ = mamba2_mixer(lp["mixer"], h, cfg, ssd_impl=ops.ssd_model_impl)
            x = x + out
        return apply_head(cfg, params, x)

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        forward_ssm(cfg, params, tokens)  # warm up both routes (cuBLAS, allocator)
        kernel_route()
        t_chunked, t_kernel = [], []
        for _ in range(3):  # in turns
            want, t = timed(lambda: forward_ssm(cfg, params, tokens)[0])
            t_chunked.append(t)
            ops.reset_launch_counts()
            got, t = timed(kernel_route)
            t_kernel.append(t)
            launches = dict(ops.LAUNCHES)
            if launches["ssd"] != cfg.num_layers:
                break
        t_chunked, t_kernel = float(np.median(t_chunked)), float(np.median(t_kernel))
        by_chunked = device_ms_by_kernel(lambda: forward_ssm(cfg, params, tokens))
        by_kernel = device_ms_by_kernel(kernel_route)
    ssd_ms = _ssd_kernel_ms(by_kernel)
    shape = (SSM_BATCH, SSM_SEQ, cfg.vocab_padded)
    if tuple(got.shape) != shape or tuple(want.shape) != shape:
        raise AssertionError(f"logits {tuple(got.shape)} / {tuple(want.shape)}, expected {shape}")
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise AssertionError("non-finite logits")
    if launches != dict.fromkeys(launches, 0) | {"ssd": cfg.num_layers}:
        raise AssertionError(f"the kernel route launched {launches}, expected the SSD kernel "
                             f"{cfg.num_layers} times and no other")
    rel = float((got - want).abs().max() / want.abs().max())
    if rel > SSM_TOL:
        raise AssertionError(f"kernel-route logits differ from forward_ssm by {rel:.3e} "
                             f"of max |logit| (tolerance {SSM_TOL})")
    say("ssm", f"{cfg.name} x{cfg.num_layers} layers, {param_count(param_descs(cfg)):,} "
        f"parameters, batch {SSM_BATCH} x {SSM_SEQ}, median of 3 warmed forwards: forward_ssm "
        f"{t_chunked:.4f} s; kernel route {t_kernel:.4f} s with {launches['ssd']} SSD calls (kernel / "
        f"forward_ssm {t_kernel / t_chunked:.3f}x); logits {shape}, max |diff| {rel:.3e} of max "
        f"|logit| {float(want.abs().max()):.4f} (tolerance {SSM_TOL})")
    for route, by in (("forward_ssm", by_chunked), ("kernel route", by_kernel)):
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        say("ssm", f"{route}: device time {sum(by.values()):.2f} ms per forward; largest: "
            + "; ".join(f"{k[:70]} {v:.2f} ms" for k, v in top))
    say("ssm", f"SSD kernels' own device time per forward (torch.profiler): "
        f"{sum(ssd_ms.values()):.2f} ms over {launches['ssd']} calls ("
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ssd_ms.items()) + ")")
    if not ssd_ms:
        raise AssertionError("the profiler saw no SSD kernel on the kernel route")
    del params, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _sdpa(q, k, v, causal: bool):
    """The library yardstick: one SDPA call on the same (B,S,N,D) inputs, in
    SDPA's (B,N,S,D) layout, with kv heads shared (enable_gqa)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=True)


def phase_flash(cfg) -> tuple:
    """Path (B): ops.flash_attention at gemma-2b's attention geometry, causal
    and non-causal, f32 and bf16. Returns (results, every kernel's launches
    on the path)."""
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import ops, ref

    b, s, nq, nkv, d = FLASH_BATCH, FLASH_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(dt_type, tag, causal)
             for dt_type, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
             for causal in (True, False)]
    inputs = {tag: tuple(torch.randn(b, s, n, d, generator=gen, device="cuda").to(dt_type)
                         for n in (nq, nkv, nkv))
              for dt_type, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
    ops.reset_launch_counts()
    outs = {(tag, causal): ops.flash_attention(*inputs[tag], causal=causal)
            for _, tag, causal in cases}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches != dict.fromkeys(launches, 0) | {"flash_attention": len(cases)}:
        raise AssertionError(f"flash path launched {launches}, expected flash attention "
                             f"{len(cases)} times and no other")
    results = {}
    for dt_type, tag, causal in cases:
        q, k, v = inputs[tag]
        tol, peak = (2e-5, F32_OPS_PER_S) if tag == "f32" else (2e-2, BF16_OPS_PER_S)
        name = f"flash {tag} {'causal' if causal else 'non-causal'}"
        want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
        err = check_close(name, outs[(tag, causal)], want, tol)
        # the largest |got - want| as a share of its allowance tol + tol |want|
        share = float(((outs[(tag, causal)].float() - want.float()).abs()
                       / (tol + tol * want.float().abs())).max())
        del want
        ms = median_ms(lambda: ops.flash_attention(q, k, v, causal=causal), 10)
        plain_ms = median_ms(lambda: ref.flash_attention_gqa_ref(q, k, v, causal=causal), 5)
        backend = SDPBackend(torch._fused_sdp_choice(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
            enable_gqa=True)).name
        note = ""
        try:
            lib_ms = median_ms(lambda: _sdpa(q, k, v, causal), 10)
        except RuntimeError as exc:
            if "deterministic" not in str(exc):
                raise
            torch.use_deterministic_algorithms(False)
            try:
                lib_ms = median_ms(lambda: _sdpa(q, k, v, causal), 10)
            finally:
                torch.use_deterministic_algorithms(True)
            note = " (timed with deterministic mode off: it refuses this call)"
        pairs = s * (s + 1) // 2 if causal else s * s
        nops = 4 * d * pairs * b * nq
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(nbytes, nops, peak)
        say("flash", f"{tag} {'causal' if causal else 'non-causal'}: within {tol} of "
            f"flash_attention_ref (max abs err {err:.3e}, {share:.1%} of the allowance); median {ms:.4f} ms "
            f"({nops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the {b_by} bound "
            f"{b_ms:.4f} ms); plain version {plain_ms:.4f} ms; SDPA ({backend}) "
            f"{lib_ms:.4f} ms{note}; kernel / SDPA {ms / lib_ms:.1f}x")
        results[(tag, causal)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                      max_abs_err=err, library_ms=lib_ms)
    del inputs, outs
    gc.collect()
    torch.cuda.empty_cache()
    return results, launches


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


def _span_seconds() -> dict:
    """Seconds by span name of what the recorder holds, drained."""
    from repro_torch import obs

    out: dict = {}
    for s in obs.drain()["spans"]:
        out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0) / 1e9
    return out


def phase_trainer(cfg) -> None:
    from repro_torch import obs
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
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3), remat="none")
    codec = DeltaCheckpointCodec(base_every=4)

    def init_state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
        return params, adamw_init(params)

    def flat_params(so):
        return torch.cat([t.reshape(-1).float() for t in tree_flatten(so.params)[0]])

    cluster = LocalCluster(root, group_commit_interval=0.02)
    obs.drain()
    obs.enable()  # the codec's parts are read from its spans
    try:
        cluster.add("data", lambda: DataPipelineStateObject(root / "data", data))
        t0 = time.perf_counter()
        # the trainer persists only when forced: at full width a persist
        # takes minutes on the host (np.savez_compressed)
        cluster.add("trainer", lambda: TrainerStateObject(
            root / "trainer", init_state, step_fn, codec=codec, device="cuda"),
            group_commit_interval=3600.0)
        t_base = time.perf_counter() - t0
        base_t = _span_seconds()
        cluster.add("metrics", lambda: MetricsStateObject(root / "metrics"))
        trainer = cluster.get("trainer")
        say("trainer", f"{cfg.name} x{cfg.num_layers} layer: "
            f"{sum(t.numel() for t in tree_flatten(trainer.params)[0]):,} parameters; "
            f"version-0 base persist {t_base:.1f} s (device {base_t['codec.encode.device']:.2f} s, "
            f"savez {base_t['codec.encode.compress']:.1f} s), {trainer.bytes_written:,} B")
        losses = []
        for _ in range(2):
            t0 = time.perf_counter()
            step, loss = _drive_step(cluster, DelayMessage)
            torch.cuda.synchronize()
            losses.append(loss)
            say("trainer", f"step {step}: loss {loss:.6f} ({time.perf_counter() - t0:.2f} s)")
        _span_seconds()
        t0 = time.perf_counter()
        label = trainer.runtime.maybe_persist(force=True)
        t_snap = time.perf_counter() - t0
        enc_t = _span_seconds()
        t_durable = t_snap + _wait(lambda: trainer.runtime.stats()["committed"] >= label,
                                   "trainer persist durable", 900)
        _wait(lambda: trainer.runtime.boundary.get("trainer", -1) >= label,
              "trainer version in the recovery boundary", 300)
        say("trainer", f"delta persist v{label}: snapshot {t_snap:.1f} s (device encode "
            f"{enc_t['codec.encode.device']:.2f} s, savez {enc_t['codec.encode.compress']:.1f} s), "
            f"durable after "
            f"{t_durable:.1f} s")
        pre = flat_params(trainer)

        _span_seconds()
        t0 = time.perf_counter()
        cluster.kill("trainer")
        t_restore = time.perf_counter() - t0
        dec_t = _span_seconds()
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
            f"{t_restore:.1f} s (blob load {dec_t['codec.decode.load']:.1f} s, device decode "
            f"{dec_t['codec.decode.device']:.3f} s); step 2 restored, params within "
            f"{worst:.3f} x the codec bound of the pre-kill params")
        step, loss = _drive_step(cluster, DelayMessage)
        if step != 2 or not math.isfinite(loss):
            raise AssertionError(f"step after restore: step {step}, loss {loss}")
        say("trainer", f"step {step} after restore: loss {loss:.6f}")
        # the full-width trainer is not persisted again on shutdown
        cluster.kill("trainer", restart=False)
    finally:
        obs.disable()
        obs.drain()
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------- #
def phase_loop(cfg) -> dict:
    """The resilient loop on LocalCluster. Returns the failure-free digest,
    the steps and the trainer-kill run's seconds, which the fabric phase is
    held against."""
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
        t1 = time.perf_counter()
        trainer_kill = run_resilient_training(root / "kt", cfg, steps=steps, kill_trainer_at=4)
        t_kill = time.perf_counter() - t1
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
        f"{rel.max():.2e}; kill_trainer_at=4 run {t_kill:.2f} s; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"digest": base.params_digest, "steps": steps, "seconds": t_kill}


#: the fabric phase's links: 1 ms +- 0.5 latency, 5% loss, 5% reordering
#: and 5% duplication on every one, two coordinator shards
FABRIC_LINK = dict(latency_ms=1.0, jitter_ms=0.5, loss_prob=0.05, reorder_prob=0.05,
                   dup_prob=0.05)
FABRIC_SHARDS = 2
PINNED_SEEDS = HERE / "tests" / "scenarios" / "regression_seeds.json"


def phase_fabric(cfg, local: dict) -> dict:
    """The resilient loop over the port's fabric on the card, then the
    pinned simulator seeds on the host. ``local`` is phase_loop's record of
    the same loop on LocalCluster. Returns the kernels' launches on the
    fabric runs (all 0: they use no codec)."""
    from repro_torch import net
    from repro_torch.kernels import ops
    from repro_torch.sim import FaultPlan
    from repro_torch.sim.explore import run_one
    from repro_torch.train import loop, run_resilient_training

    root = RUN_DIR / "fabric"
    shutil.rmtree(root, ignore_errors=True)
    steps = local["steps"]
    cluster_cls = loop.LocalCluster
    ops.reset_launch_counts()
    try:
        for runtime in ("dse", "durable"):
            transports = []

            def cluster(path, **kw):
                """In LocalCluster's place for one run: a NetCluster over a
                new lossy SimTransport, which its shutdown stops."""
                transport = net.SimTransport(seed=0, default_link=net.LinkSpec(**FABRIC_LINK))
                transports.append(transport)
                return net.NetCluster(path, transport=transport, n_shards=FABRIC_SHARDS,
                                      runtime=runtime, **kw)

            loop.LocalCluster = cluster
            try:
                t0 = time.perf_counter()
                res = run_resilient_training(root / runtime, cfg, steps=steps, kill_trainer_at=4)
                secs = time.perf_counter() - t0
            finally:
                loop.LocalCluster = cluster_cls
            ext = sorted(s for s, _ in res.external_metrics)
            if (res.params_digest != local["digest"] or res.final_step != steps
                    or ext != list(range(steps)) or res.rollbacks < 1):
                raise AssertionError(f"{cfg.name} over the fabric, {runtime}, kill_trainer_at=4: "
                                     f"digest {res.params_digest} (LocalCluster failure-free "
                                     f"{local['digest']}), step {res.final_step}, external "
                                     f"metrics steps {ext}, rollbacks {res.rollbacks}")
            if len(transports) != 1 or not transports[0]._closed:
                raise AssertionError(f"{runtime}: {len(transports)} transports, not stopped")
            st = transports[0].stats()
            say("fabric", f"{cfg.name} {runtime} runtime over a {FABRIC_SHARDS}-shard fabric "
                f"({FABRIC_LINK}), kill_trainer_at=4: digest {res.params_digest} == the "
                f"LocalCluster failure-free run's; external metrics steps 0..{steps - 1} once "
                f"each; rollbacks {res.rollbacks}; {secs:.2f} s (LocalCluster kill_trainer_at=4 "
                f"{local['seconds']:.2f} s); transport sent {st['sent']}, retries "
                f"{st['retries']}, dropped_loss {st['dropped_loss']}, duplicated "
                f"{st['duplicated']}, bytes {st['bytes']}")
        launches = dict(ops.LAUNCHES)
        if any(launches.values()):
            raise AssertionError(f"the fabric runs launched a kernel: {launches}")

        t0 = time.perf_counter()
        pinned = json.loads(PINNED_SEEDS.read_text())["pinned"]
        for entry in pinned:
            plan = FaultPlan.from_json(entry["plan"]) if "plan" in entry else None
            r = run_one(entry["scenario"], int(entry["seed"]), root / "sim", plan=plan)
            say("fabric", f"pinned {entry['scenario']} seed {entry['seed']}: {r.events} events, "
                f"{r.virtual_time:.4f} virtual s; invariants green")
        say("fabric", f"{len(pinned)} pinned simulator seeds replayed through "
            f"repro_torch.sim.explore.run_one in {time.perf_counter() - t0:.1f} s (host only)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_loop_ssm(cfg) -> dict:
    """The resilient loop on the ssm family (mamba2 smoke): a trainer kill
    ends with the failure-free digest; the delta codec's runs, failure-free
    and with a trainer kill, complete through the codec kernels. Returns the
    kernels' launches on the codec runs."""
    from repro_torch.kernels import ops
    from repro_torch.train import run_resilient_training

    steps = 8
    root = RUN_DIR / "loop_ssm"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        base = run_resilient_training(root / "base", cfg, steps=steps)
        killed = run_resilient_training(root / "kt", cfg, steps=steps, kill_trainer_at=4)
        ops.reset_launch_counts()
        codec = run_resilient_training(root / "cb", cfg, steps=steps, use_delta_codec=True)
        codec_kill = run_resilient_training(root / "ck", cfg, steps=steps, kill_trainer_at=4,
                                            use_delta_codec=True)
        launches = dict(ops.LAUNCHES)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if killed.params_digest != base.params_digest or killed.rollbacks < 1:
        raise AssertionError(f"{cfg.name} trainer kill: digest {killed.params_digest} != "
                             f"failure-free {base.params_digest} (rollbacks {killed.rollbacks})")
    for name, res in (("kill_trainer_at=4", killed), ("codec", codec),
                      ("codec, kill_trainer_at=4", codec_kill)):
        ext = sorted(s for s, _ in res.external_metrics)
        if res.final_step != steps or ext != list(range(steps)):
            raise AssertionError(f"{cfg.name} {name}: step {res.final_step}, external "
                                 f"metrics steps {ext}")
    if codec_kill.rollbacks < 1 or launches["delta_encode"] < 1:
        raise AssertionError(f"{cfg.name} codec runs: rollbacks {codec_kill.rollbacks}, "
                             f"launches {launches}")
    losses = [np.array([dict(r.external_metrics)[s] for s in range(steps)])
              for r in (base, codec, codec_kill)]
    if not all(np.all(np.isfinite(l)) for l in losses):
        raise AssertionError(f"{cfg.name} losses {losses}")
    # The codec's deltas are int8: a restore lands within half a quantisation
    # step of the persisted params, so the kill run's digest is not the
    # failure-free one (the reference's loop behaves the same). Its losses
    # stay within the loop's 5e-3 (tests/test_torch_training.py), and the
    # failure-free codec run trains exactly as a run without the codec
    rel = float(np.max(np.abs(losses[2] - losses[1]) / np.abs(losses[1])))
    if rel > 5e-3 or not np.array_equal(losses[1], losses[0]):
        raise AssertionError(f"{cfg.name} codec losses {losses[1]} / {losses[2]} vs "
                             f"{losses[0]}")
    say("loop", f"{cfg.name}: trainer-kill digest {killed.params_digest} == failure-free; "
        f"delta codec failure-free and kill_trainer_at=4 runs complete, steps 0..{steps - 1} "
        f"once each, kernel launches {launches}, digests {codec.params_digest} / "
        f"{codec_kill.params_digest} (lossy restore: "
        f"{'equal' if codec.params_digest == codec_kill.params_digest else 'differ'}), kill "
        f"run losses within {rel:.2e} of the failure-free codec run's; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_loop_families(names) -> dict:
    """The resilient loop on the moe, mla and hybrid smoke configs: a
    trainer kill ends with the failure-free digest (the MoE dispatch is
    deterministic on the card), and the external metrics list every step
    once. Returns the kernels' launches on these runs (their reference
    reaches no Pallas kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import run_resilient_training

    steps = 8
    root = RUN_DIR / "loop_families"
    ops.reset_launch_counts()
    for name in names:
        cfg = get_config(name, smoke=True)
        shutil.rmtree(root, ignore_errors=True)
        t0 = time.perf_counter()
        try:
            base = run_resilient_training(root / "base", cfg, steps=steps)
            killed = run_resilient_training(root / "kt", cfg, steps=steps, kill_trainer_at=4)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        if killed.params_digest != base.params_digest or killed.rollbacks < 1:
            raise AssertionError(f"{cfg.name} trainer kill: digest {killed.params_digest} != "
                                 f"failure-free {base.params_digest} (rollbacks {killed.rollbacks})")
        for what, res in (("failure-free", base), ("kill_trainer_at=4", killed)):
            ext = sorted(s for s, _ in res.external_metrics)
            if res.final_step != steps or ext != list(range(steps)):
                raise AssertionError(f"{cfg.name} {what}: step {res.final_step}, external "
                                     f"metrics steps {ext}")
        losses = [l for _, l in sorted(base.external_metrics)]
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{cfg.name} losses {losses}")
        say("loop", f"{cfg.name}: trainer-kill digest {killed.params_digest} == failure-free "
            f"(rollbacks {killed.rollbacks}); external metrics steps 0..{steps - 1} once each; "
            f"losses {np.round(losses, 6).tolist()}; {time.perf_counter() - t0:.1f} s")
    return dict(ops.LAUNCHES)


# --------------------------------------------------------------------------- #
def phase_train_full(cfg, card: str, policies=("none", "full")) -> dict:
    """One train step at full width under each remat policy, from the same
    state, in turns (two policies: their losses and params agree); two calls
    under one policy are bit-identical. Returns the kernels' launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import make_train_step
    from repro_torch.models import init_params, param_count, param_descs
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_flatten

    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    n_params = param_count(param_descs(cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ + 1), generator=gen,
                                     device="cuda"), **extras_for(cfg, gen)}
    steps = {r: make_train_step(cfg, AdamWConfig(lr=1e-3), remat=r) for r in policies}
    times = {r: [] for r in policies}
    peak = {r: 0 for r in policies}
    first, same = {}, {r: True for r in policies}
    for r in policies:  # warm up cuBLAS and the allocator
        steps[r](params, opt, batch)
    for rep in range(3):
        for r in (policies if rep % 2 == 0 else policies[::-1]):  # in turns
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            new_p, _, loss = steps[r](params, opt, batch)
            torch.cuda.synchronize()
            times[r].append(time.perf_counter() - t0)
            peak[r] = max(peak[r], torch.cuda.max_memory_allocated() - held)
            leaves = tree_flatten(new_p)[0]
            if r not in first:
                first[r] = (loss, leaves)
            else:
                same[r] &= torch.equal(loss, first[r][0]) and all(
                    torch.equal(a, b) for a, b in zip(leaves, first[r][1]))
            del new_p, leaves, loss
    launches = dict(ops.LAUNCHES)
    loss_0, p_0 = first[policies[0]]
    if not (bool(torch.isfinite(loss_0)) and all(bool(torch.isfinite(t).all()) for t in p_0)):
        raise AssertionError(f"{cfg.name} train step: loss {float(loss_0)}")
    if not all(same.values()):
        raise AssertionError(f"{cfg.name}: two train steps under one policy differ: {same}")
    med = {r: float(np.median(times[r])) for r in policies}
    what = [f"remat {r} median {med[r] * 1e3:.1f} ms a step, peak {peak[r] / 2**30:.2f} GiB "
            "above the state held" for r in policies]
    if len(policies) == 2:
        (loss_n, p_n), (loss_f, p_f) = first["none"], first["full"]
        scale = max(float(t.abs().max()) for t in p_n)
        p_diff = max(float((a - b).abs().max()) for a, b in zip(p_n, p_f))
        l_diff = abs(float(loss_n) - float(loss_f))
        bit = torch.equal(loss_n, loss_f) and all(torch.equal(a, b) for a, b in zip(p_n, p_f))
        if p_diff > 1e-6 * scale or l_diff > 1e-6 * abs(float(loss_n)):
            raise AssertionError(f"{cfg.name}: remat full vs none: params differ by "
                                 f"{p_diff:.3e} (max |param| {scale:.3e}), losses by {l_diff:.3e}")
        what[1] += (f" ({med['full'] / med['none']:.3f}x the time, "
                    f"{peak['full'] / peak['none']:.3f}x the memory)")
        what.append(f"full vs none: params within {p_diff:.3e} (max |param| {scale:.3f}), "
                    f"loss within {l_diff:.3e}, {'bit-identical' if bit else 'not bit-identical'}")
    src = "".join(f", 1 x {v.shape[1]} {k}" for k, v in batch.items() if k != "tokens")
    say("train_full", f"{cfg.name} {depth(cfg)}, {n_params:,} parameters, 1 x {TRAIN_SEQ} "
        f"tokens{src}, f32, loss {float(loss_0):.6f}: " + "; ".join(what) + "; two calls under "
        f"each policy bit-identical; kernel launches {launches}; {card}")
    del params, opt, first, p_0, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _attn_flops(cfg, seq: int, d_ff: int) -> int:
    """An attention block with its MLP: the products, and every (query,
    key) pair of attention (the plain path forms the masked ones too)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return (2 * seq * d * hd * (2 * nq + 2 * nkv) + 2 * 2 * seq * seq * nq * hd
            + 2 * seq * 3 * d * d_ff)


def _mla_flops(cfg, seq: int) -> int:
    """MLA: the q and kv projections, the expansion of the latent into
    k_nope and v at every position, both logit terms and P V."""
    m, d, nq = cfg.mla, cfg.d_model, cfg.num_heads
    qk, R = m.qk_nope_head_dim + m.qk_rope_head_dim, m.kv_lora_rank
    q = (2 * seq * d * m.q_lora_rank + 2 * seq * m.q_lora_rank * nq * qk if m.q_lora_rank
         else 2 * seq * d * nq * qk)
    return (q + 2 * seq * d * (R + m.qk_rope_head_dim)
            + 2 * seq * R * nq * (m.qk_nope_head_dim + m.v_head_dim)
            + 2 * seq * seq * nq * (qk + m.v_head_dim) + 2 * seq * nq * m.v_head_dim * d)


def _moe_flops(cfg, seq: int) -> int:
    """The reference's GShard dispatch as ``layers.moe`` runs it: the router,
    the one-hot dispatch and combine products over (t, k, E, C), the
    (E, C, D) gather and scatter products over every token, the experts on
    their C slots, and the shared MLP."""
    mo, d = cfg.moe, cfg.d_model
    E, k = mo.num_experts, mo.top_k
    tg = min(2048, seq)
    T = seq
    C = math.ceil(tg * k / E * mo.capacity_factor)
    groups = T // tg
    return (2 * T * d * E + 2 * 2 * T * k * E * C + T * k * E + 2 * 2 * T * E * C * d
            + groups * 3 * 2 * E * C * d * mo.d_expert
            + 2 * T * 3 * d * mo.num_shared * mo.d_expert)


def _ssm_flops(cfg, seq: int) -> int:
    """A Mamba-2 block as ``models.ssm`` runs it: the projections, the
    depthwise conv, and the chunked SSD's four products (C B within a
    chunk, the masked products with x, the chunk states, and the carried
    states' contribution)."""
    s, d = cfg.ssm, cfg.d_model
    di, nh, gn = s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state
    L = min(s.chunk_size, seq)
    return (2 * seq * d * (2 * di + 2 * gn + nh) + 2 * seq * s.d_conv * (di + 2 * gn)
            + 2 * seq * L * (gn + nh * s.head_dim) + 2 * 2 * seq * nh * s.head_dim * s.d_state
            + 2 * seq * di * d)


def _cross_flops(cfg, seq: int, src: int) -> int:
    """Cross-attention of ``seq`` queries over ``src`` source positions: q
    and the output projection, K and V projected from the source, and every
    (query, source) pair."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return 2 * seq * d * hd * 2 * nq + 2 * src * d * hd * 2 * nkv + 2 * 2 * seq * src * nq * hd


def _cross_kv_flops(cfg) -> int:
    """The cross-attention K and V that one decode step projects again from
    the whole source (the reference keeps no cross K/V cache)."""
    kv = 2 * 2 * cfg.d_model * cfg.num_kv_heads * cfg.resolved_head_dim
    if cfg.family == "encdec":
        return cfg.num_layers * kv * cfg.source_len
    return cfg.num_layers // cfg.cross_attn_period * kv * cfg.num_image_tokens


def _prefill_flops(cfg, seq: int) -> int:
    """Operations of one prefill at batch 1, by the reference's algorithm
    in each family, and the head on the last position."""
    head = 2 * cfg.d_model * cfg.vocab_padded
    if cfg.family == "encdec":  # the encoder over the frames, then the decoder
        return (cfg.encoder_layers * _attn_flops(cfg, cfg.source_len, cfg.d_ff)
                + cfg.num_layers * (_attn_flops(cfg, seq, cfg.d_ff)
                                    + _cross_flops(cfg, seq, cfg.source_len)) + head)
    if cfg.family == "vlm":  # per group: the self blocks, then the gated cross block
        p, groups = cfg.cross_attn_period, cfg.num_layers // cfg.cross_attn_period
        return groups * ((p - 1) * _attn_flops(cfg, seq, cfg.d_ff)
                         + _cross_flops(cfg, seq, cfg.num_image_tokens)
                         + 2 * seq * 3 * cfg.d_model * cfg.d_ff) + head
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.hybrid_attn_period
        return groups * _attn_flops(cfg, seq, cfg.d_ff) + cfg.num_layers * _ssm_flops(cfg, seq) + head
    if cfg.moe is None:
        return cfg.num_layers * _attn_flops(cfg, seq, cfg.d_ff) + head
    dense, n_moe = cfg.moe.first_k_dense, cfg.num_layers - cfg.moe.first_k_dense
    if cfg.mla is not None:
        attn = _mla_flops(cfg, seq)
        dense_mlp = 2 * seq * 3 * cfg.d_model * cfg.moe.dense_d_ff
    else:
        attn = _attn_flops(cfg, seq, 0)
        dense_mlp = 2 * seq * 3 * cfg.d_model * cfg.d_ff
    return dense * (attn + dense_mlp) + n_moe * (attn + _moe_flops(cfg, seq)) + head


def phase_prefill(card: str, names) -> dict:
    """make_prefill_step on each model at full width, one at a time.
    Returns the kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import forward, init_params, param_count, param_descs

    ops.reset_launch_counts()
    for name in names:
        cfg = on_card(name)
        gc.collect()
        torch.cuda.empty_cache()
        n_params = param_count(param_descs(cfg))
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ), generator=gen,
                                         device="cuda")}
        open_gates(cfg, params, gen)
        extras = extras_for(cfg, gen)
        batch.update(extras)
        step = make_prefill_step(cfg)
        ms = median_ms(lambda: step(params, batch), 3)
        last = step(params, batch)
        with torch.no_grad():
            want = forward(cfg, params, batch["tokens"], extras=extras)[0][:, -1:]
        if last.shape != (1, 1, cfg.vocab_padded) or not bool(torch.isfinite(last).all()):
            raise AssertionError(f"{cfg.name} prefill logits {tuple(last.shape)}")
        rel = float((last - want).abs().max() / want.abs().max())
        if rel > 1e-5:
            raise AssertionError(f"{cfg.name}: last_only logits differ from the full forward's "
                                 f"last row by {rel:.3e} of max |logit|")
        flops = _prefill_flops(cfg, PREFILL_SEQ)
        tflops = flops / ms / 1e9
        plan = ""
        if cfg.global_period:
            n_local = cfg.num_layers - cfg.num_layers // cfg.global_period
            plan = f", window {cfg.sliding_window} on {n_local} of {cfg.num_layers} layers"
        elif cfg.moe is not None:
            n_moe = cfg.num_layers - cfg.moe.first_k_dense
            share = n_moe * _moe_flops(cfg, PREFILL_SEQ) / flops
            plan = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} on {n_moe} layers "
                    f"(the MoE layers {share:.1%} of the operations)")
        elif cfg.family == "hybrid":
            plan = (f", the shared attention block at {cfg.num_layers // cfg.hybrid_attn_period}"
                    f" sites among {cfg.num_layers} SSM layers")
        elif cfg.family == "encdec":
            enc = cfg.encoder_layers * _attn_flops(cfg, cfg.source_len, cfg.d_ff)
            cross = cfg.num_layers * _cross_flops(cfg, PREFILL_SEQ, cfg.source_len)
            plan = (f", 1 x {cfg.source_len} frames (the encoder {enc / flops:.1%} of the "
                    f"operations, the cross-attention {cross / flops:.1%})")
        elif cfg.family == "vlm":
            groups = cfg.num_layers // cfg.cross_attn_period
            plan = (f", its first {groups} of {get_config(name).num_layers // cfg.cross_attn_period}"
                    f" groups ({groups * (cfg.cross_attn_period - 1)} self and {groups} gated "
                    f"cross blocks, the gates set non-zero), 1 x {cfg.num_image_tokens} image "
                    f"tokens")
        say("prefill", f"{cfg.name} {depth(cfg)}, {n_params:,} parameters "
            f"({n_params * 4 / 1e9:.2f} GB f32){plan}, 1 x {PREFILL_SEQ} tokens: median "
            f"{ms:.2f} ms of 3 warmed calls, {flops / 1e12:.3f} TFLOP, {tflops:.2f} TFLOP/s "
            f"({tflops / (F32_OPS_PER_S / 1e12):.1%} of the 67 TFLOP/s f32 peak, TF32 off); "
            f"last_only logits == the full forward's last row within {rel:.3e} of max |logit|; "
            f"{card}")
        del params, last, want, batch, extras
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ops.LAUNCHES)


# --------------------------------------------------------------------------- #
#: teacher-forced decode positions held against one forward: a multiple of
#: the SSD chunk for the families with SSM blocks (ssd_chunked refuses
#: other lengths). The hybrid's forward is held with its SSD chunk set to
#: 64 (_held): the chunk is how the forward splits the sequence, not a
#: width of the model, and 64 positions instead of zamba2's chunk of 256
#: keep the phase within the script's time
SERVE_T = {"dense": 64, "moe": 64, "ssm": 256, "hybrid": 64, "encdec": 64, "vlm": 64}
#: the f32 decode's steps where its logits are printed against the forward's,
#: not held (the families checked in float64): 8 warm-up steps and 8 timed
SERVE_TIMED = 16
#: the warmed decode steps under torch.profiler, whose device time, launches
#: and idle share are printed, not held: the profiler's own cost grows with
#: the events it records (8 steps took 9.5-26.4 s a model on an H100)
SERVE_PROFILED = 4
#: decode logits against the forward's, relative to max |logit|. gemma-2b's
#: random weights make its attention a hard argmax (the init takes the
#: fan-in of wq (D, N, H) as N, so the attention logits have a std near
#: 700), and 18 layers amplify f32 rounding to O(1): on an H100 its f32
#: forward differs from a float64 forward by 0.83 of max |logit| (PERF.md,
#: examples/torch_decode_drift.py).
#: So the checks of the families with attention run in float64, where the
#: same amplification leaves the two about 4e-7 apart. mamba2-370m runs in
#: f32; its forward runs the f32 chunked SSD, whose drift through 48 layers
#: sets SSM_TOL.
SERVE_TOL = {"dense": 1e-4, "moe": 1e-4, "ssm": SSM_TOL, "hybrid": 1e-4, "encdec": 1e-4,
             "vlm": 1e-4}
SERVE_CHECK_DTYPE = {"dense": torch.float64, "moe": torch.float64, "ssm": torch.float32,
                     "hybrid": torch.float64, "encdec": torch.float64, "vlm": torch.float64}
#: models whose float64 check is held at a cut of their plan, full width:
#: name -> groups, layers, or MoE layers after the dense ones.
#: gemma3-4b's random model (wq's fan-in taken as its 8 heads: layer-0
#: attention logits of std 886) is chaotic even in float64 over 34 layers:
#: on an H100 its float64 decode and forward part by 1.7e-13 of max |hidden|
#: after layer 0, 4.0e-7 after 12 layers and 5.5e-2 after 34, growing layer
#: by layer (examples/torch_decode_drift.py --arch gemma3-4b --layers 34),
#: so it is held at its first two groups and its 4-layer tail (16 layers:
#: every stack of the plan). granite-moe-3b-a800m's is too (layer-0
#: attention logits of std 105): its float64 decode and forward part by
#: 2.4e-14 of max |hidden| after layer 0, 1.7e-5 after 16 and 2.9e-2 of max
#: |logit| after 32 (examples/torch_decode_drift.py --arch
#: granite-moe-3b-a800m), so it is held at its first 16 layers.
#: deepseek-v2-lite-16b's float64 weights (126 GB) do not fit the card: it
#: is held at its dense layer and first four MoE layers (22.7 GB in float64).
#: llama-3.2-vision-90b's first VLM_GROUPS groups (85.3 GB in float64) do
#: not either: it is held at its first group (51.1 GB in float64)
SERVE_CHECK_CUT = {"gemma3-4b": 2, "granite-moe-3b-a800m": 16, "deepseek-v2-lite-16b": 4,
                   "llama-3.2-vision-90b": 1}


def _held(cfg):
    """The config a decode is held against. MoE: capacity factor E / k, so
    the experts take every (token, slot): a forward over T tokens drops a
    slot past its expert's capacity ceil(T k / E x factor), which one
    decoded token (capacity 1, k distinct experts) never meets. The hybrid:
    its SSD chunk set to SERVE_T (see there). The decode itself is the same
    under either config; the other families are returned as they are."""
    if cfg.moe is not None:
        mo = cfg.moe
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            mo, capacity_factor=mo.num_experts / mo.top_k))
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=SERVE_T["hybrid"]))
    return cfg


def _cut(cfg, params, n: int):
    """The config and params of a plan cut to its first ``n`` groups and its
    whole tail (gemma3), to its first ``n`` groups (the vlm), to its dense
    layers and first ``n`` MoE layers (deepseek), or to its first ``n``
    layers (the flat plan). The cut stacks are copies, so the full model can
    be freed."""
    from repro_torch.tree import tree_map

    cut = dict(params)
    if cfg.family == "vlm":
        for k in ("group_selfs", "group_cross"):
            cut[k] = tree_map(lambda t: t[:n].clone(), params[k])
        return dataclasses.replace(cfg, num_layers=n * cfg.cross_attn_period), cut
    if cfg.global_period:
        tail = cfg.num_layers % cfg.global_period
        for k in ("group_locals", "group_global"):
            cut[k] = tree_map(lambda t: t[:n].clone(), params[k])
        return dataclasses.replace(cfg, num_layers=n * cfg.global_period + tail), cut
    key, dense = ("moe_layers", cfg.moe.first_k_dense) if "moe_layers" in params else ("layers", 0)
    cut[key] = tree_map(lambda t: t[:n].clone(), params[key])
    return dataclasses.replace(cfg, num_layers=dense + n), cut


def _decode_weights(cfg) -> int:
    """Parameters one decode step reads: all but the encoder (it runs once,
    before decoding) and, when the head is not tied to it, the input
    embedding table (one row is read)."""
    from repro_torch.models import param_count, param_descs

    descs = param_descs(cfg)
    n = param_count(descs)
    if "encoder" in descs:
        n -= param_count(descs["encoder"])
    if not cfg.tie_embeddings:
        n -= (cfg.vocab_padded - 1) * cfg.d_model
    return n


def _expert_params(cfg) -> int:
    """Parameters of the routed experts (0 without MoE)."""
    if cfg.moe is None:
        return 0
    mo = cfg.moe
    return (cfg.num_layers - mo.first_k_dense) * 3 * mo.num_experts * cfg.d_model * mo.d_expert


def _timed_restores(serve) -> tuple:
    """Wrap DecodeSessionStateObject.Restore to record (tokens replayed,
    seconds to the end of the replay on the card); returns the record list
    and leaves the wrapper installed until the caller restores it."""
    record, restore = [], serve.DecodeSessionStateObject.Restore

    def timed(self, version):
        t0 = time.perf_counter()
        meta = restore(self, version)
        torch.cuda.synchronize()
        record.append((len(self.tokens), time.perf_counter() - t0))
        return meta

    serve.DecodeSessionStateObject.Restore = timed
    return record, restore


def _serve_full(cfg, card: str) -> None:
    """Decode timing and idle share, a failure-free serving run against one
    with a kill, then teacher-forced decode against forward, at full width
    (last: its float64 copy may need the memory the f32 model holds)."""
    from repro_torch.models import (cache_descs, decode_step, forward, init_params,
                                    param_count, param_descs, zeros_from_descs)
    from repro_torch.train import run_speculative_serving, serve
    from repro_torch.tree import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    t_parts, t0 = {}, time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
    n_params = param_count(param_descs(cfg))
    T, tol = SERVE_T[cfg.family], SERVE_TOL[cfg.family]
    tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device="cuda")
    open_gates(cfg, params, gen)
    ext = extras_for(cfg, gen)
    held = _held(cfg)

    def teacher_forced(p, dtype, c=held, e=ext, n=T):
        """decode_step over the first n of the T tokens: the logits (1, n, V)
        and the ms of each step, which ends in the host's argmax as a
        serving step does.
        An encdec cache first gets the encoder output from a forward with
        the cache, as the reference's tests prime it (a serving session
        decodes against the zeros of an empty cache instead)."""
        cache = zeros_from_descs(cache_descs(c, 1, T), dtype, "cuda")
        if c.family == "encdec":
            forward(c, p, tokens[:, :1], extras=e, cache=cache, cache_index=0)
        out, step_ms = [], []
        for i in range(n):
            t0 = time.perf_counter()
            logits, cache = decode_step(c, p, cache, tokens[:, i: i + 1], i, extras=e)
            int(torch.argmax(logits[0, 0, : cfg.vocab_size]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)
        return torch.cat(out, dim=1), step_ms

    def rel_diff(got, want) -> float:
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode logits {tuple(got.shape)}, forward {tuple(want.shape)}")
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    check = SERVE_CHECK_DTYPE[cfg.family]
    n32 = T if check == torch.float32 else min(T, SERVE_TIMED)  # held over T in f32 only
    with torch.no_grad():
        got, step_ms = teacher_forced(params, torch.float32, n=n32)
        want = forward(held, params, tokens, extras=ext)[0]
        rel32 = rel_diff(got, want[:, :n32])
        moe_note = ""
        if cfg.moe is not None:
            moe_note = (f"; the forward at the published capacity factor "
                        f"{cfg.moe.capacity_factor}, which drops (token, slot)s past an "
                        f"expert's capacity, differs from the f32 decode by "
                        f"{rel_diff(got, forward(cfg, params, tokens)[0][:, :n32]):.3e}")
        del got
        cache = zeros_from_descs(cache_descs(cfg, 1, 64), torch.float32, "cuda")

        def profiled_steps():
            for i in range(SERVE_PROFILED):
                lg, _ = decode_step(cfg, params, cache, tokens[:, i: i + 1], i, extras=ext)
                int(torch.argmax(lg[0, 0, : cfg.vocab_size]))

        t_parts["f32 decode and forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = profile(profiled_steps)
        del cache, profiled_steps
    t_parts["profile"] = time.perf_counter() - t0
    kernels, host = by_name(events, device=True), by_name(events, device=False)
    ms = float(np.median(step_ms[8:]))  # the first steps warm up cuBLAS and the allocator
    dev_ms = sum(m for m, _ in kernels.values()) / SERVE_PROFILED
    launches = sum(n for _, n in kernels.values()) / SERVE_PROFILED
    b_ms = n_params * 4 / HBM_BYTES_PER_S * 1e3
    bound = f"batch-1 HBM bound {b_ms:.3f} ms (weight bytes over 3.35 TB/s)"
    active = ""
    if cfg.family in ("encdec", "vlm"):
        read, kv = _decode_weights(cfg), _cross_kv_flops(cfg)
        r_ms, kv_ms = read * 4 / HBM_BYTES_PER_S * 1e3, kv / F32_OPS_PER_S * 1e3
        b_ms = max(r_ms, kv_ms)
        src = cfg.source_len if cfg.family == "encdec" else cfg.num_image_tokens
        bound = (f"batch-1 bound {b_ms:.3f} ms ({'bytes' if r_ms >= kv_ms else 'operations'}: the "
                 f"{read:,} weights a step reads over 3.35 TB/s, {r_ms:.3f} ms; the "
                 f"cross-attention K/V projected again from {src} source positions, "
                 f"{kv / 1e9:.1f} GFLOP over the f32 peak, {kv_ms:.3f} ms)")
    if cfg.moe is not None:
        a_params = n_params - _expert_params(cfg) * (1 - cfg.moe.top_k / cfg.moe.num_experts)
        active = (f"; the active-expert bound (top-{cfg.moe.top_k} of {cfg.moe.num_experts} "
                  f"experts, {a_params:,.0f} parameters) {a_params * 4 / HBM_BYTES_PER_S * 1e3:.3f}"
                  f" ms, which the one-hot dispatch does not reach: it reads every expert")
    say("serve", f"{cfg.name} decode: median {ms:.3f} ms per token over steps 8..{n32 - 1} "
        f"({1e3 / ms:.1f} tokens/s); {bound}, {b_ms / ms:.1%} of it{active}; {SERVE_PROFILED} "
        f"warmed steps under torch.profiler: device "
        f"time {dev_ms:.3f} ms and {launches:.0f} kernel launches per step, idle share "
        f"{1 - dev_ms / ms:.1%} of the median step; {card}")
    for what, table in (("device time per step by kernel", kernels),
                        ("host self time per step by operator (profiled)", host)):
        top = sorted(table.items(), key=lambda kv: -kv[1][0])[:6]
        say("serve", f"{cfg.name} decode {what}: "
            + "; ".join(f"{k[:60]} {m / SERVE_PROFILED:.3f} ms x{n / SERVE_PROFILED:.0f}"
                        for k, (m, n) in top))

    t0 = time.perf_counter()
    if cfg.name == "gemma-2b":
        _seq_constraint_timing(cfg, params, tokens, card)
        t_parts["decode_seq_constraint timing"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    root = RUN_DIR / "serve"
    shutil.rmtree(root, ignore_errors=True)
    record, restore = _timed_restores(serve)
    try:
        t0 = time.perf_counter()
        base = run_speculative_serving(root / "base", cfg, params, n_tokens=16, extras=ext)
        t_base = time.perf_counter() - t0
        killed = run_speculative_serving(root / "kill", cfg, params, n_tokens=16, kill_at=8,
                                         extras=ext)
        # the same replay over all 16 durable tokens, timed directly
        so = serve.DecodeSessionStateObject(root / "replay", cfg, params, max_len=64,
                                            extras=ext)
        so.tokens = list(base.durable_tokens)
        t0 = time.perf_counter()
        so._rebuild_cache()
        torch.cuda.synchronize()
        t_16 = time.perf_counter() - t0
        del so
    finally:
        serve.DecodeSessionStateObject.Restore = restore
        shutil.rmtree(root, ignore_errors=True)
    if len(base.durable_tokens) != 16 or base.tokens_generated != 16:
        raise AssertionError(f"{cfg.name}: failure-free run {base}")
    if (killed.durable_tokens != base.durable_tokens or killed.rollbacks != 1
            or killed.tokens_generated != 16):
        raise AssertionError(f"{cfg.name}: kill run {killed} != failure-free {base}")
    n_rep, t_rep = max(record) if record else (0, 0.0)
    say("serve", f"{cfg.name} run_speculative_serving(n_tokens=16): {t_base:.3f} s "
        f"({16 / t_base:.1f} tokens/s end to end); kill_at=8: rollbacks 1, the same 16 durable "
        f"tokens {base.durable_tokens}; its Restore replayed {n_rep} tokens in {t_rep:.4f} s; "
        f"a replay of all 16 takes {t_16:.4f} s; {card}")
    del base, killed
    gc.collect()
    t_parts["serving runs and replay"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    cut = SERVE_CHECK_CUT.get(cfg.name)
    note = ""
    with torch.no_grad():
        if check == torch.float32:
            rel = rel32
        else:
            e64 = {k: v.to(check) for k, v in ext.items()}
            if cut is None:
                p64 = tree_map(lambda t: t.to(check), params)
                want64 = forward(held, p64, tokens, extras=e64)[0]
                rel = rel_diff(teacher_forced(p64, check, e=e64)[0], want64)
                note = (f" (in f32 over {n32} tokens the two differ by {rel32:.3e}, and the "
                        f"f32 forward from a "
                        f"float64 one by {rel_diff(want, want64):.3e}: rounding amplified by the "
                        f"random model, not held)")
                del p64, want64
            else:
                note = (f" (in f32 at all {cfg.num_layers} layers over {n32} tokens the two "
                        f"differ by {rel32:.3e}; "
                        f"float64 at all {cfg.num_layers} not run: see SERVE_CHECK_CUT)")
                c_cfg, c_p64 = _cut(held, params, cut)
                del params
                gc.collect()
                torch.cuda.empty_cache()
                to_dtype(c_p64, check)
                rel = rel_diff(teacher_forced(c_p64, check, c_cfg, e64)[0],
                               forward(c_cfg, c_p64, tokens, extras=e64)[0])
                what = (f"its first {cut} groups and its tail" if cfg.global_period
                        else "its first group" if cfg.family == "vlm" and cut == 1
                        else f"its first {cut} groups" if cfg.family == "vlm"
                        else f"its dense layer and first {cut} MoE layers"
                        if "moe_layers" in c_p64 else f"its first {cut} layers")
                note += f"; held at {what} ({c_cfg.num_layers} layers), full width"
                del c_p64
            note = f" in {str(check).removeprefix('torch.')}" + note
    if rel > tol:
        raise AssertionError(f"{cfg.name}: teacher-forced decode differs from forward by "
                             f"{rel:.3e} of max |logit| (tolerance {tol}){note}")
    primed = (f" (primed with the encoder output of 1 x {cfg.source_len} seeded frames)"
              if cfg.family == "encdec" else
              f" (1 x {cfg.num_image_tokens} seeded image tokens, the gates set non-zero)"
              if cfg.family == "vlm" else "")
    say("serve", f"{cfg.name} {depth(cfg)} layers, {n_params:,} parameters "
        f"({n_params * 4 / 1e9:.2f} GB f32), batch 1: teacher-forced decode_step over {T} tokens"
        f"{primed} == one forward within {rel:.3e} of max |logit| (tolerance {tol}){note}"
        f"{moe_note}; {card}")
    del want, ext
    gc.collect()
    torch.cuda.empty_cache()
    if check != torch.float32:
        t_parts[f"{str(check).removeprefix('torch.')} check"] = time.perf_counter() - t0
    say("time", f"serve {cfg.name}: " + ", ".join(f"{k} {v:.1f} s" for k, v in t_parts.items()))


def _seq_constraint_timing(cfg, params, tokens, card: str) -> None:
    """Decode ms per token with Tuning.decode_seq_constraint off and on (the
    grouped einsum over the un-repeated cache), in turns: off, on, on, off.
    Timed only: the random f32 gemma-2b amplifies the two einsums' rounding
    (see SERVE_TOL)."""
    from repro_torch.models import cache_descs, decode_step, tuning, zeros_from_descs

    n = 16
    step_ms = {False: [], True: []}
    with torch.no_grad():
        for flag in (False, True, True, False):
            cache = zeros_from_descs(cache_descs(cfg, 1, n), torch.float32, "cuda")
            with tuning(decode_seq_constraint=flag):
                for i in range(n):
                    t0 = time.perf_counter()
                    logits, cache = decode_step(cfg, params, cache, tokens[:, i: i + 1], i)
                    int(torch.argmax(logits[0, 0, : cfg.vocab_size]))
                    if i >= 8:
                        step_ms[flag].append((time.perf_counter() - t0) * 1e3)
    off, on = (float(np.median(step_ms[f])) for f in (False, True))
    say("serve", f"{cfg.name} decode, Tuning.decode_seq_constraint off / on, in turns (off, on, "
        f"on, off; steps 8..{n - 1} of each pass): median {off:.3f} / {on:.3f} ms per token "
        f"(on / off {on / off:.3f}x); {card}")


def _margins(cfg, params, tokens: list, extras: dict) -> list:
    """Top-2 logit margin of each greedy step that produced ``tokens``."""
    from repro_torch.models import cache_descs, decode_step, zeros_from_descs

    cache = zeros_from_descs(cache_descs(cfg, 1, 64), torch.float32, "cuda")
    out = []
    with torch.no_grad():
        for i, t in enumerate([0] + tokens[:-1]):
            tok = torch.tensor([[t]], device="cuda")
            lg, cache = decode_step(cfg, params, cache, tok, i, extras=extras)
            top2 = torch.topk(lg[0, 0, : cfg.vocab_size], 2).values
            out.append(f"{float(top2[0] - top2[1]):.2e}")
    return out


#: the models served at full width, and the smoke configs served on the card
#: and on the CPU (every ported architecture)
SERVE_FULL = ("gemma_2b", "gemma3_4b", "mamba2_370m", "granite_moe_3b_a800m",
              "deepseek_v2_lite_16b", "zamba2_1p2b") + CROSS_FAMILIES
ARCHS = ("seamless_m4t_large_v2", "yi_6b", "gemma_2b", "glm4_9b", "gemma3_4b", "zamba2_1p2b",
         "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "mamba2_370m", "llama_3p2_vision_90b")


def phase_serve(card: str) -> dict:
    """The serving path at full width and at the smoke configs. Returns every
    kernel's launches on it (all 0, checked)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, param_descs
    from repro_torch.train import run_speculative_serving
    from repro_torch.tree import tree_map

    one = torch.zeros(1, device="cuda")
    one.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        one.add_(1)
    torch.cuda.synchronize()
    say("serve", f"host cost of one launch of a one-element add_: "
        f"{(time.perf_counter() - t0) * 1e3:.2f} us (mean of 1000); {card}")
    ops.reset_launch_counts()
    for name in SERVE_FULL:
        timed(f"serve {name}", _serve_full, on_card(name), card)
    t0 = time.perf_counter()
    root = RUN_DIR / "serve_smoke"
    shutil.rmtree(root, ignore_errors=True)
    try:
        for name in ARCHS:
            cfg = get_config(name, smoke=True)
            # gemma3 smoke: 24 tokens wrap its window-8 ring caches twice
            n = 24 if cfg.global_period else 16
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
            open_gates(cfg, params, gen)
            ext = extras_for(cfg, gen)
            card_run = run_speculative_serving(root / f"{name}_card", cfg, params, n_tokens=n,
                                               extras=ext)
            cpu_run = run_speculative_serving(root / f"{name}_cpu", cfg,
                                              tree_map(lambda t: t.cpu(), params), n_tokens=n,
                                              extras=tree_map(lambda t: t.cpu(), ext),
                                              device="cpu")
            if card_run.durable_tokens != cpu_run.durable_tokens or len(cpu_run.durable_tokens) != n:
                margins = _margins(cfg, params, card_run.durable_tokens, ext)
                raise AssertionError(f"{cfg.name}: served on the card {card_run.durable_tokens}, "
                                     f"on the CPU {cpu_run.durable_tokens}; the card's top-2 "
                                     f"logit margins {margins}")
            say("serve", f"{cfg.name}: the {n} tokens served on the card equal a CPU run's "
                f"from the same weights{' and extras' * bool(ext)} {card_run.durable_tokens}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("time", f"phase serve smoke configs, card and CPU: {time.perf_counter() - t0:.1f} s")
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"the serving path launched a kernel: {ops.LAUNCHES}")
    say("serve", f"kernel launches on the serving path: {dict(ops.LAUNCHES)} (its reference "
        f"reaches no Pallas kernel)")
    return dict(ops.LAUNCHES)


# --------------------------------------------------------------------------- #
#: the ep phase: one MoE layer, EP against the einsum dispatch (relative to
#: max |y|). On a world of one both have the same capacity and drop order
#: and differ only in how the combine rounds (1.6e-7 on an H100)
EP_LAYER_TOL = 1e-5
#: the ep phase's train step: its loss against the einsum step's, relative.
#: The random granite is chaotic in f32: the combine's rounding parts the
#: two routes' prefill logits by 2.8e-2 of max |logit| at 8 layers and 0.92
#: at 16 on an H100 (PERF.md); the loss, a mean over 2048 positions,
#: moved 1.7e-4 at 12 layers
EP_LOSS_TOL = 1e-3


def _held_rel(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |got - want| / max |want|, which must be finite and within tol."""
    rel = float((got - want).abs().max() / want.abs().max())
    if not bool(torch.isfinite(got).all()) or not rel <= tol:
        raise AssertionError(f"{name}: {rel:.3e} of max |want| apart (tol {tol})")
    return rel


def _ep_moe_flops(cfg, seq: int) -> int:
    """The EP dispatch's operations in one MoE layer of ``layers.moe``: the
    router, the experts on every one of their C slots, the shared MLP (the
    scatter and gather into the buckets move bytes, and do no products)."""
    mo, d = cfg.moe, cfg.d_model
    C = math.ceil(seq * mo.top_k / mo.num_experts * mo.capacity_factor)
    return (2 * seq * d * mo.num_experts + 3 * 2 * mo.num_experts * C * d * mo.d_expert
            + 2 * seq * 3 * d * mo.num_shared * mo.d_expert)


def phase_ep(card: str) -> dict:
    """granite-moe at full width through ``Tuning.moe_impl="ep"`` on a
    world-of-one NCCL mesh, against the einsum dispatch: one MoE layer, a
    prefill and a train step, and the int8 gradient compression on the card
    against the CPU. Returns the kernels' launches."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import make_prefill_step, make_train_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, param_descs, tuning
    from repro_torch.models.layers import moe, moe_descs
    from repro_torch.optim import AdamWConfig, adamw_init, compress_gradients_int8
    from repro_torch.parallel.ep_moe import ep_mesh
    from repro_torch.tree import tree_flatten, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    cfg = get_config("granite_moe_3b_a800m")
    rdzv = Path(tempfile.mkdtemp(prefix="chip_smoke_ep_"))
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/rdzv", world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    try:
        mesh = make_host_mesh(model=1)

        def ep(fn):
            with ep_mesh(mesh), tuning(moe_impl="ep"):
                return fn()

        # (a) one MoE layer at 1 x 2048 tokens, and its gradients compressed
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_params(moe_descs(cfg), gen, dtype=torch.float32, device="cuda")
        x = torch.randn((1, PREFILL_SEQ, cfg.d_model), generator=gen, device="cuda")
        with torch.no_grad():
            y0, aux0 = moe(p, x, cfg)
            y1, aux1 = ep(lambda: moe(p, x, cfg))
            ms_e = median_ms(lambda: moe(p, x, cfg), 10)
            ms_p = median_ms(lambda: ep(lambda: moe(p, x, cfg)), 10)
            by_kernel = device_ms_by_kernel(lambda: ep(lambda: moe(p, x, cfg)))
        rel = _held_rel("ep layer", y1, y0, EP_LAYER_TOL)
        aux_rel = abs(float(aux1) - float(aux0)) / abs(float(aux0))
        if aux_rel > EP_LAYER_TOL:
            raise AssertionError(f"ep layer: aux {float(aux1)} vs the einsum's {float(aux0)}")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
        flops_e, flops_p = _moe_flops(cfg, PREFILL_SEQ), _ep_moe_flops(cfg, PREFILL_SEQ)
        say("ep", f"{cfg.name} one MoE layer ({cfg.moe.num_experts} experts top-"
            f"{cfg.moe.top_k}, d {cfg.d_model}, d_expert {cfg.moe.d_expert}), 1 x {PREFILL_SEQ} "
            f"tokens, f32, world-of-one NCCL mesh: EP == einsum within {rel:.3e} of max |y| "
            f"(tol {EP_LAYER_TOL}), aux within {aux_rel:.3e}; median of 10: einsum {ms_e:.4f} ms "
            f"({flops_e / 1e9:.1f} GFLOP), EP {ms_p:.4f} ms ({flops_p / 1e9:.1f} GFLOP), "
            f"{ms_e / ms_p:.3f}x; EP device ms {sum(by_kernel.values()):.4f}, the most "
            + ", ".join(f"{k[:48]} {v:.4f}" for k, v in top) + f"; {card}")

        leaves = tree_flatten(p)[0]
        for t in leaves:
            t.requires_grad_(True)
        y = ep(lambda: moe(p, x, cfg))[0]
        grads = dict(zip(("router", "w_down", "w_gate", "w_up"),
                         torch.autograd.grad(y.square().sum(), leaves)))
        ef_card = tree_map(torch.zeros_like, grads)
        grads_cpu, ef_cpu = tree_map(lambda t: t.cpu(), grads), tree_map(lambda t: t.cpu(), ef_card)
        for _ in range(2):  # two steps: the second adds the first's residual
            out_card = compress_gradients_int8(grads, ef_card)
            out_cpu = compress_gradients_int8(grads_cpu, ef_cpu)
            ef_card, ef_cpu = out_card[2], out_cpu[2]
            if not all(torch.equal(a.cpu(), b) for a, b in zip(tree_flatten(out_card)[0],
                                                               tree_flatten(out_cpu)[0])):
                raise AssertionError("compress_gradients_int8 on the card differs from the CPU's")
        ms_c = median_ms(lambda: compress_gradients_int8(grads, ef_card), 5)
        n = sum(t.numel() for t in leaves)
        say("ep", f"compress_gradients_int8 over the layer's {n:,} gradient values, two steps of "
            f"error feedback: codes, scales, residuals bit-equal to the CPU's; {ms_c:.3f} ms on "
            f"the card; {card}")
        del p, x, y, y0, y1, leaves, grads, ef_card, grads_cpu, ef_cpu, out_card, out_cpu
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the prefill at the prefill phase's depth, held in float64 at the
        # depth where the random model is not chaotic (SERVE_CHECK_CUT)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ), generator=gen,
                                         device="cuda")}
        step = make_prefill_step(cfg)
        ms = {"einsum": median_ms(lambda: step(params, batch), 3),
              "ep": median_ms(lambda: ep(lambda: step(params, batch)), 3)}
        last = {"einsum": step(params, batch), "ep": ep(lambda: step(params, batch))}
        for r, t in last.items():
            if t.shape != (1, 1, cfg.vocab_padded) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"ep prefill ({r}) logits {tuple(t.shape)}")
        f32_rel = float((last["ep"] - last["einsum"]).abs().max() / last["einsum"].abs().max())
        n_cut = SERVE_CHECK_CUT[cfg.name]
        cut_cfg, cut = _cut(cfg, params, n_cut)
        del params, last
        gc.collect()
        to_dtype(cut, torch.float64)
        cut_step = make_prefill_step(cut_cfg)
        f64_rel = _held_rel("ep prefill float64", ep(lambda: cut_step(cut, batch)),
                            cut_step(cut, batch), SERVE_TOL["moe"])
        del cut
        flops = _prefill_flops(cfg, PREFILL_SEQ)
        n_moe = cfg.num_layers - cfg.moe.first_k_dense
        flops_ep = flops - n_moe * (_moe_flops(cfg, PREFILL_SEQ) - _ep_moe_flops(cfg, PREFILL_SEQ))
        say("ep", f"prefill {cfg.name} x{cfg.num_layers}, 1 x {PREFILL_SEQ} tokens, f32, median of "
            f"3 warmed calls: einsum {ms['einsum']:.2f} ms ({flops / ms['einsum'] / 1e9:.2f} "
            f"TFLOP/s of {flops / 1e12:.3f} TFLOP, _prefill_flops), EP {ms['ep']:.2f} ms "
            f"({flops / ms['ep'] / 1e9:.2f} TFLOP/s at that count; {flops_ep / ms['ep'] / 1e9:.2f}"
            f" of its own {flops_ep / 1e12:.3f} TFLOP), {ms['einsum'] / ms['ep']:.3f}x; logits in "
            f"f32 {f32_rel:.3e} of max |logit| apart (the chaotic random model, not held); in "
            f"float64 at its first {n_cut} layers EP == einsum within {f64_rel:.3e} "
            f"(tol {SERVE_TOL['moe']}); {card}")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) one train step at TRAIN_MOE_LAYERS under remat "full"
        c12 = dataclasses.replace(cfg, num_layers=TRAIN_MOE_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(param_descs(c12), gen, dtype=torch.float32, device="cuda")
        opt = adamw_init(params)
        batch = {"tokens": torch.randint(0, c12.vocab_size, (1, TRAIN_SEQ + 1), generator=gen,
                                         device="cuda")}
        train = make_train_step(c12, AdamWConfig(lr=1e-3), remat="full")
        runs = {"einsum": lambda: train(params, opt, batch),
                "ep": lambda: ep(lambda: train(params, opt, batch))}
        times, out, peak = {r: [] for r in runs}, {}, 0
        for r, fn in runs.items():
            fn()  # warm up
            for _ in range(2):
                gc.collect()
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                new_p, _, loss = fn()
                torch.cuda.synchronize()
                times[r].append((time.perf_counter() - t0) * 1e3)
                if r == "ep":
                    peak = max(peak, torch.cuda.max_memory_allocated() - held)
                out.setdefault(r, []).append((loss, tree_flatten(new_p)[0] if r == "ep" else []))
                del new_p
        (loss_a, p_a), (loss_b, p_b) = out["ep"]
        if not (torch.equal(loss_a, loss_b) and all(torch.equal(u, v) for u, v in zip(p_a, p_b))):
            raise AssertionError("two EP train steps from one state differ")
        loss_e = out["einsum"][0][0]
        loss_rel = abs(float(loss_a) - float(loss_e)) / abs(float(loss_e))
        if not bool(torch.isfinite(loss_a)) or loss_rel > EP_LOSS_TOL:
            raise AssertionError(f"EP train step loss {float(loss_a)} vs the einsum's "
                                 f"{float(loss_e)}")
        say("ep", f"train step {cfg.name} x{TRAIN_MOE_LAYERS}, 1 x {TRAIN_SEQ} tokens, f32, remat "
            f"full: einsum {np.median(times['einsum']):.1f} ms, EP {np.median(times['ep']):.1f} "
            f"ms ({np.median(times['einsum']) / np.median(times['ep']):.3f}x), EP peak "
            f"{peak / 2**30:.2f} GiB above the state held; loss EP {float(loss_a):.6f} vs einsum "
            f"{float(loss_e):.6f} ({loss_rel:.3e} relative, tol {EP_LOSS_TOL}); two EP steps "
            f"bit-identical; {card}")
        del params, opt, out, p_a, p_b
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ops.LAUNCHES)


# --------------------------------------------------------------------------- #
#: the dry run's cells on the 16 x 16 mesh: (arch, shape, variant, CLI flags)
DRYRUN_CELLS = (("gemma-2b", "train_4k", "baseline", ()),
                ("mamba2-370m", "prefill_32k", "baseline", ()),
                ("gemma-2b", "train_4k", "tuned", ("--constrain-activations",)))
#: each cell under the earlier planner, which left undivided dims replicated
#: (PERF.md section 6):
#: (per-card flops, all-gathers, wire bytes, where they were counted). The
#: wire bytes differ between torch 2.11 (the card's machine) and 2.13 (the
#: CPU), so each figure names its run
DRYRUN_BEFORE = {
    ("gemma-2b", "train_4k", "baseline"): (3.1530e14, 9, 3.5320e10,
                                           "the card's machine, the earlier planner"),
    ("mamba2-370m", "prefill_32k", "baseline"): (1.1400e13, 241, 6.5203e10,
                                                 "the CPU, torch 2.13, the earlier planner"),
    ("gemma-2b", "train_4k", "tuned"): (3.1530e14, 9, 3.7718e10,
                                        "the CPU, torch 2.13, the earlier planner"),
}
#: runs the CLI once per cell in one process (each call makes and destroys
#: its own fake process group; a failed cell exits 1)
_DRYRUN_RUNNER = """
import sys
from repro_torch.launch import dryrun
out = sys.argv[1]
for cell in sys.argv[2:]:
    arch, shape, variant, *flags = cell.split(",")
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single", "--variant", variant,
                 "--out", out] + flags)
"""
DRYRUN_OUT = RUN_DIR / "dryrun"
CALIBRATION_ARCH = "yi_6b"


def phase_dryrun(card: str) -> tuple:
    """The dry run's DRYRUN_CELLS in one subprocess, then the counter
    against the card on yi-6b's prefill. Returns the kernels' launches of
    each: the subprocess's count over its cells (the dryrun path, each 0)
    and this process's over the calibration."""
    from repro_torch.analysis.aten_cost import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import init_params, param_descs

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    cells = DRYRUN_OUT / "cells.jsonl"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", _DRYRUN_RUNNER, str(cells)]
                         + [",".join((a, s, v) + f) for a, s, v, f in DRYRUN_CELLS],
                         capture_output=True, text=True, timeout=600, cwd=str(HERE),
                         env={**os.environ, "PYTHONPATH": str(HERE / "src")})
    secs = time.perf_counter() - t0
    (DRYRUN_OUT / "stdout.txt").write_text(run.stdout)
    (DRYRUN_OUT / "stderr.txt").write_text(run.stderr)
    recs = [json.loads(line) for line in cells.read_text().splitlines()] if cells.exists() else []
    briefs = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    if (run.returncode != 0 or len(recs) != len(DRYRUN_CELLS) or len(briefs) != len(recs)
            or any(r["status"] != "ok" for r in recs)):
        raise AssertionError(f"dry run of {DRYRUN_CELLS}: rc {run.returncode}, records "
                             f"{[(r.get('arch'), r.get('status'), r.get('error')) for r in recs]}"
                             f"\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    launches = {k: 0 for k in ops.LAUNCHES}
    for brief in briefs:
        assert set(brief["launches"]) == set(ops.LAUNCHES), brief["launches"]
        for k, n in brief["launches"].items():
            launches[k] += n
    if any(launches.values()):
        raise AssertionError(f"the dry run launched a kernel: {launches}")
    for (arch, shape, variant, _), rec, brief in zip(DRYRUN_CELLS, recs, briefs):
        rf, coll = rec["roofline"], rec["collectives"]
        flops0, ag0, wire0, where0 = DRYRUN_BEFORE[(arch, shape, variant)]
        say("dryrun", f"{rec['arch']} {rec['shape']} ({rec['variant']}) on {rec['mesh']} "
            f"({rec['chips']} fake ranks, torch {torch.__version__}; kernel launches "
            f"{brief['launches']}): status {rec['status']}, traced in {rec['compile_s']} s; per "
            f"card {rec['cost']['flops']:.4e} flops ({rec['cost']['flops'] / flops0:.3f}x the "
            f"{flops0:.4e} before), {coll.get('n_all-gather', 0)} all-gathers "
            f"(before: {ag0}), {coll['total']:.4e} wire bytes (before: {wire0:.4e}; the before "
            f"figures from {where0}); {rec['cost']['bytes accessed']:.4e} bytes: compute "
            f"{rf['compute_s']:.6f} s, memory {rf['memory_s']:.6f} s, collective "
            f"{rf['collective_s']:.6f} s ({rf['dominant']}); HBM estimate "
            f"{rec['memory_est']['hbm_fraction']:.4f} of 80 GB")
    say("dryrun", f"{len(recs)} cells in one subprocess in {secs:.1f} s; kernel launches on "
        f"the dryrun path {launches} (all 0)")

    cfg = get_config(CALIBRATION_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(param_descs(cfg), gen, dtype=torch.float32, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ), generator=gen,
                                     device="cuda")}
    step = make_prefill_step(cfg)
    ops.reset_launch_counts()
    ms = median_ms(lambda: step(params, batch), 3)
    with OpCounter() as counter:
        step(params, batch)
    torch.cuda.synchronize()
    calibration = dict(ops.LAUNCHES)
    flops, nbytes = counter.cost_dict()["flops"], counter.bytes_accessed
    analytic = _prefill_flops(cfg, PREFILL_SEQ)
    roof_ms, roof_by = bound_ms(nbytes, flops)
    say("dryrun", f"calibration: {cfg.name} x{cfg.num_layers} make_prefill_step, 1 x "
        f"{PREFILL_SEQ} tokens, f32, a world of one: counted {counter.dot_flops / 1e12:.4f} dot "
        f"TFLOP ({counter.dot_flops / analytic:.4f} x _prefill_flops' {analytic / 1e12:.4f}), "
        f"{counter.elementwise_flops / 1e12:.4f} elementwise TFLOP, {nbytes / 1e9:.3f} GB "
        f"accessed (unfused); roofline {roof_ms:.2f} ms ({roof_by}, at 67 TFLOP/s f32 and 3.35 "
        f"TB/s); measured {ms:.2f} ms (median of 3 warmed calls, {ms / roof_ms:.3f} x the "
        f"roofline); {card}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, calibration


def timed(phase: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    say("time", f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import delta_encode as k_delta
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import ssd as k_ssd
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

    t0 = time.perf_counter()
    sources = (k_delta.SOURCE, k_ssd.SOURCE, k_flash.SOURCE)
    for src, (path, secs) in zip(sources, build.build_all(sources)):
        say("build", f"{src.name}: {path.relative_to(HERE)} "
            + (f"compiled in {secs:.1f} s" if secs else "already built"))
        hmma = sass_counts(path, "HMMA")
        for fn, regs, stores, loads in ptxas_report(path.with_suffix(".log").read_text()):
            say("build", f"  ptxas {fn}: {regs} registers, {stores} B spill stores, {loads} B "
                f"spill loads" + (f"; {hmma[fn]} HMMA in its SASS" if fn in hmma else ""))
    say("build", f"nvcc {' '.join(build.NVCC_FLAGS)}: all built in "
        f"{time.perf_counter() - t0:.1f} s")

    say("time", f"phase env and build: {time.perf_counter() - t_start:.1f} s")
    full = dataclasses.replace(get_config("gemma_2b"), num_layers=1)
    nb = -(-param_count(param_descs(full)) // BLOCK)
    kern = timed("kernels", phase_kernels, nb)

    mamba = get_config("mamba2_370m")
    ssd_res = timed("ssd", phase_ssd, mamba)
    paths = {"ssm": timed("ssm", phase_ssm, mamba)}
    flash_res, paths["flash"] = timed("flash", phase_flash, get_config("gemma_2b"))

    ops.reset_launch_counts()
    timed("trainer", phase_trainer, full)
    paths["trainer"] = dict(ops.LAUNCHES)
    say("trainer", f"kernel launches on the main path: {paths['trainer']}")

    local = timed("loop", phase_loop, get_config("gemma_2b", smoke=True))
    paths["fabric"] = timed("fabric", phase_fabric, get_config("gemma_2b", smoke=True), local)
    paths["loop_mamba2_codec"] = timed("loop_ssm", phase_loop_ssm,
                                       get_config("mamba2_370m", smoke=True))
    paths["loop_moe_mla_hybrid"] = timed("loop_families", phase_loop_families, NEW_FAMILIES)
    paths["train_full"] = timed("train_full", phase_train_full, mamba, card)
    granite = dataclasses.replace(get_config("granite_moe_3b_a800m"), num_layers=TRAIN_MOE_LAYERS)
    paths["train_full_moe"] = timed("train_full_moe", phase_train_full, granite, card,
                                    policies=("full",))
    seamless = dataclasses.replace(get_config("seamless_m4t_large_v2"),
                                   num_layers=TRAIN_ENCDEC_LAYERS,
                                   encoder_layers=TRAIN_ENCDEC_LAYERS)
    paths["train_full_encdec"] = timed("train_full_encdec", phase_train_full, seamless, card,
                                       policies=("full",))
    paths["prefill"] = timed("prefill", phase_prefill, card, ("yi_6b", "glm4_9b", "gemma3_4b")
                             + NEW_FAMILIES + CROSS_FAMILIES)
    paths["ep"] = timed("ep", phase_ep, card)
    paths["serve"] = timed("serve", phase_serve, card)
    paths["dryrun"], paths["dryrun_calibration"] = timed("dryrun", phase_dryrun, card)
    # every count was set to 0 just before each path and read just after it;
    # ``launches`` is each kernel's count on the path it was ported for
    own = {"delta_encode": "trainer", "delta_decode": "trainer", "ssd": "ssm",
           "flash_attention": "flash"}
    launches = {name: paths[path][name] for name, path in own.items()}
    path_launches = {name: {path: counts[name] for path, counts in paths.items()}
                     for name in own}

    # the line reports each kernel at f32 inputs, and SSD and flash attention
    # (causal) also at bf16, their tensor-core paths
    measured = [(name, "f32", kern[(name, "f32")]) for name in ("delta_encode", "delta_decode")]
    measured += [("ssd", tag, ssd_res[tag]) for tag in ("f32", "bf16")]
    measured += [("flash_attention", tag, flash_res[(tag, True)]) for tag in ("f32", "bf16")]
    source = {"delta_encode": k_delta.SOURCE, "delta_decode": k_delta.SOURCE,
              "ssd": k_ssd.SOURCE, "flash_attention": k_flash.SOURCE}
    replaces = {"delta_encode": "src/repro/kernels/delta_encode.py:24",
                "delta_decode": "src/repro/kernels/delta_encode.py:32",
                "ssd": "src/repro/kernels/ssd.py:24",
                "flash_attention": "src/repro/kernels/flash_attention.py:26"}
    line = {"kernels": [
        dict(name=name, dtype=tag, route="cuda",
             source=source[name].relative_to(HERE).as_posix(), replaces=replaces[name],
             launches=launches[name], path_launches=path_launches[name],
             max_abs_err=m["max_abs_err"], ms=m["ms"],
             plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
             library_ms=m.get("library_ms"))
        for name, tag, m in measured
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
