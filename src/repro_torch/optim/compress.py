"""Int8 gradient compression with error feedback (port of
``repro/optim/compress.py``).

Compress local gradients to int8 with one scale per tensor, and carry the
quantisation residual into the next step (error feedback keeps
convergence). Both ``torch.round`` and ``jnp.round`` round half to even, and
every division is by a tensor (on the card, PyTorch divides by a Python
scalar as a multiplication by its reciprocal), so codes, scales and
residuals are bit-equal to the reference's.
"""
from __future__ import annotations

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten


def compress_gradients_int8(grads, error_feedback):
    """Returns (codes int8 tree, scales tree, new_residual tree)."""

    def enc(g, e):
        g = g.to(torch.float32) + e
        amax = g.abs().max()
        scale = torch.clamp(amax, min=1e-30) / amax.new_tensor(127.0)
        codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        resid = g - codes.to(torch.float32) * scale
        return codes, scale, resid

    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(error_feedback)[0]
    enc_out = [enc(g, e) for g, e in zip(flat_g, flat_e)]
    codes = tree_unflatten(treedef, [o[0] for o in enc_out])
    scales = tree_unflatten(treedef, [o[1] for o in enc_out])
    resid = tree_unflatten(treedef, [o[2] for o in enc_out])
    return codes, scales, resid


def decompress_gradients_int8(codes, scales):
    return tree_map(lambda c, s: c.to(torch.float32) * s, codes, scales)
