"""Delta-compressed checkpoint codec (port of ``repro/checkpoint/delta.py``).

The blob format is the reference's, so blobs interchange both ways:
``np.savez_compressed`` with ``kind`` (0 base, 1 delta), ``flat`` (a base's
f32 parameter stream) or ``codes``/``scales``/``n`` (a delta's int8 codes,
per-block f32 scales and stream length), and ``o{i}`` for the i-th
optimizer leaf in ``jax.tree_util`` order (``m*``, ``step``, ``v*``).

* PARAMETERS: a full f32 base every ``base_every`` versions, int8 deltas of
  blocks of ``_BLOCK`` values in between. The stream is flattened and padded
  on the device and the encode kernel runs there; the previous stream stays
  on the device, and only codes and scales travel to the host.
* OPTIMIZER MOMENTS are stored raw: an f32 leaf is kept as fp16 only when
  it round-trips within 1e-3 relative error (the reference's policy; Adam's
  second moment spans orders of magnitude that block quantisation of deltas
  would round to zero).

Restore replays base + deltas through the decode kernel and loads the
moments of the last blob directly.

Each call records the recorder's (``obs``) spans: ``codec.encode`` with
``codec.encode.device`` (flatten, the fp16 policy, the encode kernel and
the copies to the host) and ``codec.encode.compress`` (``np.savez_compressed``);
``codec.decode`` with ``codec.decode.load`` (``np.load``, the copies to the
device, the unflatten) and ``codec.decode.device`` (the decode kernel).
"""
from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels import ops as kops
from ..tree import TreeDef, tree_flatten, tree_unflatten

_BLOCK = 1024


def _flatten(tree) -> Tuple[torch.Tensor, List, TreeDef]:
    """Leaves in jax.tree_util order -> one f32 stream on the leaves' device."""
    leaves, treedef = tree_flatten(tree)
    if leaves:
        flat = torch.cat([t.reshape(-1).float() for t in leaves])
    else:
        flat = torch.zeros(0, dtype=torch.float32)
    shapes = [(tuple(t.shape), t.dtype) for t in leaves]
    return flat, shapes, treedef


def _unflatten(flat: torch.Tensor, shapes, treedef: TreeDef):
    out, off = [], 0
    for shape, dt in shapes:
        n = int(np.prod(shape)) if shape else 1
        out.append(flat[off: off + n].reshape(shape).to(dt, copy=True))
        off += n
    return tree_unflatten(treedef, out)


def _pad_blocks(flat: torch.Tensor) -> torch.Tensor:
    n = flat.numel()
    nb = max(1, (n + _BLOCK - 1) // _BLOCK)
    padded = torch.zeros(nb * _BLOCK, dtype=torch.float32, device=flat.device)
    padded[:n] = flat
    return padded.reshape(nb, _BLOCK)


def _opt_host_arrays(opt) -> Dict[str, np.ndarray]:
    """Optimizer leaves for the blob, with the fp16 policy applied on the
    device so only the chosen representation crosses to the host."""
    arrays: Dict[str, np.ndarray] = {}
    for i, a in enumerate(tree_flatten(opt)[0]):
        if a.dtype == torch.float32:
            a16 = a.half()
            rel = (a16.float() - a).abs() / torch.clamp(a.abs(), min=1e-12)
            if float(rel.max()) < 1e-3:
                a = a16
        arrays[f"o{i}"] = a.cpu().numpy()
    return arrays


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeltaCheckpointCodec:
    def __init__(self, base_every: int = 8) -> None:
        self.base_every = base_every

    def encode(self, version: int, state, prev_flat: Optional[torch.Tensor]):
        """state = (params, opt_state). Returns (blob, new params stream on
        the device). prev_flat None => full params base."""
        with obs.span("codec.encode", version=version):
            with obs.span("codec.encode.device"):
                params, opt = state
                p_flat, _, _ = _flatten(params)
                opt_arrays = _opt_host_arrays(opt)
                is_base = prev_flat is None or prev_flat.numel() != p_flat.numel()
                if is_base:
                    arrays = dict(kind=np.array(0), flat=p_flat.cpu().numpy(), **opt_arrays)
                else:
                    codes, scales = kops.delta_encode(_pad_blocks(p_flat),
                                                      _pad_blocks(prev_flat))
                    arrays = dict(kind=np.array(1), codes=codes.cpu().numpy(),
                                  scales=scales.cpu().numpy(), n=np.array(p_flat.numel()),
                                  **opt_arrays)
            with obs.span("codec.encode.compress"):
                buf = io.BytesIO()
                np.savez_compressed(buf, **arrays)
            return buf.getvalue(), p_flat

    def decode_chain(self, blobs: List[bytes], p_shapes, p_treedef, o_shapes, o_treedef,
                     device):
        """Replay [base, delta, ...] on ``device``; the LAST blob carries the
        optimizer moments. Returns ((params, opt_state), params stream)."""
        device = torch.device(device)
        flat: Optional[torch.Tensor] = None
        last = None
        with obs.span("codec.decode"):
            for blob in blobs:
                with obs.span("codec.decode.load"):
                    z = np.load(io.BytesIO(blob))
                    last = z
                    if int(z["kind"]) == 0:
                        flat = torch.from_numpy(z["flat"]).to(device)
                        continue
                    if flat is None:
                        raise ValueError("delta blob before any base")
                    codes = torch.from_numpy(z["codes"]).to(device)
                    scales = torch.from_numpy(z["scales"]).to(device)
                    n = int(z["n"])
                with obs.span("codec.decode.device"):
                    dec = kops.delta_decode(codes, scales, _pad_blocks(flat), dtype=torch.float32)
                    flat = dec.reshape(-1)[:n]
                    _sync(device)
            if flat is None or last is None:
                raise ValueError("empty blob chain")
            with obs.span("codec.decode.load"):
                params = _unflatten(flat, p_shapes, p_treedef)
                o_leaves = [
                    torch.from_numpy(np.asarray(last[f"o{i}"])).to(device=device, dtype=dt)
                    .reshape(shape)
                    for i, (shape, dt) in enumerate(o_shapes)
                ]
                opt = tree_unflatten(o_treedef, o_leaves)
                _sync(device)
        return (params, opt), flat
