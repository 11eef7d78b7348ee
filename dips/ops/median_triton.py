"""Exact window median as one Pallas kernel for NVIDIA GPUs (Triton).

XLA compiles ``networks.window_median`` as w vertical tap slices, a column
sort and a rank-pruned merge network over w*w shifted views
(``networks.column_median_plan``), and materialises much of that in device
memory.  At w=7 it is about 350 min/max per pixel, the one stage of the
step nearer the ALU than memory.  Here one program owns a ``bh x bw``
output tile: it loads the w vertical taps of each horizontal offset
straight from the padded plane (the overlap between programs is served
from cache), sorts each column in registers and runs the same merge plan,
so no intermediate plane reaches device memory.

Compares run in float16: the intensities are integers in [0, 510], exact
in float16, so the median is bit-identical to the float32 one.  Block
shapes are powers of two (Triton's rule); planes that do not tile are
padded up to the tile and the result cropped.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import networks

#: windows whose exact median runs here on a GPU (each measured faster
#: than XLA's network, end to end in the 1080p step; PERF.md, PR 1)
WINDOWS = (3, 5, 7)

#: output tile rows, columns and warps per program (measured best at
#: w = 3, 5 and 7 alike among 4-8 rows x 64-256 columns, 4-8 warps)
BH, BW, NUM_WARPS = 8, 128, 4


def _kernel(x_ref, o_ref, *, window: int):
    i, j = pl.program_id(1), pl.program_id(2)
    r0, c0 = i * BH, j * BW
    col_sort, merge_ops, target = networks.column_median_plan(window)
    full = [(a, b, True, True) for a, b in col_sort]
    wires = []
    for dx in range(window):
        taps = [x_ref[pl.ds(r0 + dy, BH), pl.ds(c0 + dx, BW)]
                .astype(jnp.float16) for dy in range(window)]
        wires.extend(networks.apply_network(taps, full, jnp.minimum,
                                            jnp.maximum))
    out = networks.apply_network(wires, merge_ops, jnp.minimum, jnp.maximum)
    o_ref[...] = out[target].astype(o_ref.dtype)


#: ``pl.pallas_call``; the CPU tests swap in its interpreted form
_pallas_call = pl.pallas_call


def window_median(padded: jnp.ndarray, window: int) -> jnp.ndarray:
    """(..., H + 2p, W + 2p) f32 integer-valued planes, already padded by
    p = window // 2 on every side -> (..., H, W) exact ``window`` x
    ``window`` medians (``networks.window_median`` semantics)."""
    p = window // 2
    lead = padded.shape[:-2]
    hh, ww = padded.shape[-2], padded.shape[-1]
    h, w = hh - 2 * p, ww - 2 * p
    ht, wt = -(-h // BH) * BH, -(-w // BW) * BW
    x = padded.reshape((-1, hh, ww))
    if (ht, wt) != (h, w):
        x = jnp.pad(x, ((0, 0), (0, ht - h), (0, wt - w)))
    out = _pallas_call(
        functools.partial(_kernel, window=window),
        grid=(x.shape[0], ht // BH, wt // BW),
        in_specs=[pl.BlockSpec((None,) + x.shape[1:],
                               lambda b, i, j: (b, 0, 0))],
        out_specs=pl.BlockSpec((None, BH, BW), lambda b, i, j: (b, i, j)),
        out_shape=jax.ShapeDtypeStruct((x.shape[0], ht, wt), x.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name=f"window_median_w{window}",
    )(x)
    return out[:, :h, :w].reshape(lead + (h, w))
