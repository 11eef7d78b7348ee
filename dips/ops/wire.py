"""Transfer-efficient wire formats for device->host / server->client hops.

THRESHOLD diff maps are binary masks stored one byte per pixel (the
reference reads back full RGBA rows for every frame with 256-byte row
padding, dips/src/gpu/mod.rs:346-391 — 32 bits per mask pixel on the
wire).  Packing them to 1 bit per pixel on the device before the D2H
copy cuts the transfer 8x (24x vs a 3-channel map), which matters
wherever the link — PCIe at 4K, or a TCP client — is the bottleneck rather
than the kernel.

Masks are packed along the ROW axis (8 rows -> 1 byte-plane row), not the
width axis: the minor dimension keeps its 128-multiple padded width, so
the device layout needs no relayout before the copy.  Padded height is
always a multiple of 8 (pad_geometry tiles to (8, 128)).

Bit order is little-endian within each byte (numpy ``bitorder="little"``):
original row ``8*r + i`` lives at packed row ``r``, bit ``i``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_WEIGHTS = np.asarray([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)


@jax.jit
def pack_mask(out: jax.Array) -> jax.Array:
    """uint8 mask (..., H, W) with H % 8 == 0 -> packed uint8 (..., H//8, W).

    Any non-zero byte counts as a set bit, so it accepts both {0, 255}
    masks and {0, 1} bit planes.
    """
    bits = (out > 0).astype(jnp.uint8)
    # explicit row count: reshape(-1) cannot be inferred for a zero-size
    # array, and the host twin (np.packbits) handles empties fine
    grouped = bits.reshape(*bits.shape[:-2], bits.shape[-2] // 8, 8,
                           bits.shape[-1])
    weights = jnp.asarray(_WEIGHTS).reshape(8, 1)
    return (grouped * weights).sum(-2, dtype=jnp.uint8)


def unpack_mask(packed: np.ndarray) -> np.ndarray:
    """Packed uint8 (..., H // 8, W) -> uint8 {0, 255} mask (..., H, W)."""
    return unpack_mask_host(packed, packed.shape[-2] * 8)


def pack_mask_host(out: np.ndarray) -> np.ndarray:
    """Host-side twin of :func:`pack_mask` (numpy, for TCP payloads).
    Unlike the device twin it accepts any H — numpy zero-pads the row axis
    to a byte boundary; invert with :func:`unpack_mask_host`."""
    return np.packbits(out > 0, axis=-2, bitorder="little")


def unpack_mask_host(packed: np.ndarray, h: int) -> np.ndarray:
    """Packed uint8 (..., ceil(h/8), W) -> uint8 {0, 255} mask (..., h, W).

    The single owner of the wire bit-order contract for consumers that
    need the crop (``h`` need not be a multiple of 8)."""
    bits = np.unpackbits(np.ascontiguousarray(packed), axis=-2, count=h,
                         bitorder="little")
    return bits * np.uint8(255)
