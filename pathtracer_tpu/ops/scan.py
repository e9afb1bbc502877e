"""Parallel primitives: exclusive scan, stream compaction, radix sort.

Re-design of the reference's standalone `stream_compaction/` library
(reference stream_compaction/efficient.cu, radix_sort.cu, common.cu) in
plain jnp:

  - `exclusive_scan`: the reference's work-efficient Blelloch scan
    (efficient.cu:19-187) as `jnp.cumsum(x) - x`; XLA picks the scan
    algorithm for the device.
  - `compact`: map-to-boolean -> exclusive scan -> scatter
    (Efficient::compact, efficient.cu:250-332; Common::kernMapToBoolean /
    kernScatter, common.cu:25-46). The scatter builds a gather permutation so
    the payload moves via gathers.
  - `partition_stable`: liveness partition that KEEPS dead elements at the
    back (wavefront lanes carry their pixel through the permutation; see
    engine/wavefront.py).
  - `sort_by_key`: stable LSD radix sort, one bit per pass over the live key
    range (RadixSort::sort / onestep, radix_sort.cu:16-165).
  - `sort_by_key_multisort` / `sort_by_key_segmented`: one multi-operand
    lax.sort, the engine's COALESCED material sort.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


@jax.jit
def exclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum of a 1-D array (any length, i32/f32)."""
    return jnp.cumsum(x) - x


# ---------------------------------------------------------------------------
# Compaction / partition
# ---------------------------------------------------------------------------

def _scatter_perm(dst: jnp.ndarray, n: int) -> jnp.ndarray:
    """gather_idx[j] = i where dst[i] == j (dst a permutation of 0..n-1)."""
    iota = jnp.arange(n, dtype=jnp.int32)
    return jnp.zeros((n,), jnp.int32).at[dst].set(iota, unique_indices=True)


def partition_multisort(tree, mask: jnp.ndarray):
    """Stable liveness partition via XLA's multi-operand sort: the payload
    rides inside the sort network instead of being gathered afterwards.

    Returns (packed_tree, live_count): live lanes first, stable; dead lanes
    preserved at the back, stable.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    key = jnp.where(mask, 0, 1).astype(jnp.int32)
    iota = jnp.arange(mask.shape[0], dtype=jnp.int32)
    out = jax.lax.sort([key, iota] + leaves, num_keys=2)
    live_count = jnp.sum(mask.astype(jnp.int32))
    return jax.tree_util.tree_unflatten(treedef, out[2:]), live_count


def sort_by_key_multisort(keys: jnp.ndarray, tree):
    """Stable sort of a pytree by integer keys via one multi-operand lax.sort
    (the COALESCED material sort when the pool is not a multiple of 128)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    iota = jnp.arange(keys.shape[0], dtype=jnp.int32)
    out = jax.lax.sort([keys.astype(jnp.int32), iota] + leaves, num_keys=2)
    return out[0], jax.tree_util.tree_unflatten(treedef, out[2:])


def sort_by_key_segmented(keys: jnp.ndarray, tree, seg: int = 128):
    """Stable sort of a pytree by integer keys WITHIN each column of a
    (rows, seg=128) view — lax.sort along dimension 0, so no operand is
    relaid out.

    The COALESCED material sort only uses the permutation for memory/lane
    locality — shading is elementwise and the deferred pixel unsort undoes
    ANY permutation exactly — so clustering within columns instead of
    globally changes nothing about the image (bit-equal; tests/test_engine).
    A lane starting in column c stays in column c forever, which is also
    what makes the final segmented pixel unsort an exact inverse."""
    n = keys.shape[0]
    assert n % seg == 0, f"pool {n} not divisible by segment {seg}"
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    iota = jnp.arange(n, dtype=jnp.int32)
    ops = [a.reshape(-1, seg)
           for a in [keys.astype(jnp.int32), iota] + leaves]
    out = jax.lax.sort(ops, dimension=0, num_keys=2)
    flat = [a.reshape(-1) for a in out]
    return flat[0], jax.tree_util.tree_unflatten(treedef, flat[2:])


def compaction_indices(mask: jnp.ndarray
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable-partition permutation from a liveness mask.

    Returns (gather_idx [N] i32, live_count [] i32): gather_idx[:live_count]
    are the indices of live elements in order; the rest index dead elements in
    order (the reference's remove_if discards them; we keep them at the back
    so terminated wavefront lanes ride along — see engine docstring).
    """
    n = mask.shape[0]
    b = mask.astype(jnp.int32)
    live_pos = exclusive_scan(b)                 # rank among live
    live_count = live_pos[-1] + b[-1]
    iota = jnp.arange(n, dtype=live_pos.dtype)
    dead_pos = iota - live_pos                               # rank among dead
    dst = jnp.where(mask, live_pos, live_count + dead_pos)
    return _scatter_perm(dst, n), live_count


def gather_tree(tree, idx: jnp.ndarray):
    """Apply a gather permutation to every [N] leaf of a pytree."""
    return jax.tree_util.tree_map(lambda a: a[idx], tree)


def compact(tree, mask: jnp.ndarray):
    """Stream compaction of a pytree of [N] arrays by a boolean mask.

    Matches StreamCompaction::Efficient::compact semantics
    (efficient.cu:250-332): live elements packed to the front in stable order;
    returns (packed_tree, live_count). Trailing slots hold the dead elements
    (stable) rather than garbage.
    """
    idx, count = compaction_indices(mask)
    return gather_tree(tree, idx), count


def partition_stable(tree, mask: jnp.ndarray):
    """Alias of `compact` emphasizing that dead elements are preserved."""
    return compact(tree, mask)


# ---------------------------------------------------------------------------
# Radix sort
# ---------------------------------------------------------------------------

def sort_by_key(keys: jnp.ndarray, tree, n_bits: int = 6):
    """Stable LSD radix sort of a pytree by non-negative integer keys.

    One bit per pass (RadixSort::sort, radix_sort.cu:97-165): partition by
    the bit via two exclusive scans, ones offset by totalZeros, permutation
    applied by gather. `n_bits` covers the key range (material ids are tiny;
    the reference burns 32 passes, radix_sort.cu:104).

    Returns (sorted_keys, sorted_tree).
    """
    n = keys.shape[0]
    keys = keys.astype(jnp.int32)

    def one_pass(carry, p):
        keys, idx = carry
        bit = (keys >> p) & 1
        zeros = 1 - bit
        zeros_excl = exclusive_scan(zeros)                   # radix_to_bools
        total_zeros = zeros_excl[-1] + zeros[-1]
        ones_excl = jnp.cumsum(bit) - bit
        dst = jnp.where(bit == 0, zeros_excl, total_zeros + ones_excl)
        g = _scatter_perm(dst, n)
        return (keys[g], idx[g]), None

    idx0 = jnp.arange(n, dtype=jnp.int32)
    (sorted_keys, perm), _ = jax.lax.scan(
        one_pass, (keys, idx0), jnp.arange(n_bits, dtype=jnp.int32))
    return sorted_keys, gather_tree(tree, perm)
