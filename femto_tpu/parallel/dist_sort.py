"""Distributed multi-key sample sort over a 1-D device mesh.

The mesh counterpart of the reference's two-pass distribution Sorter +
sample splitters feeding MPI bins (/root/reference/src/utils_cc/sort.hh:64-620,
distributor_node.hh:50-683): pass 1 = local sort + splitter bucketing +
all_to_all exchange; pass 2 = local merge sort + exact rebalance to equal
blocks.  All shapes static; skew is surfaced as an overflow scalar (see
bins.py) for host-side retry with a larger capacity.

Keys are tuples of int32 arrays compared lexicographically; callers append a
unique tiebreak key (e.g. global index) so all keys are distinct, which is
what makes regular sampling's balance bound hold for adversarial inputs.
Invalid/pad lanes sort to the end (key = INT32_MAX sentinel).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .bins import INT32_MAX, exchange, valiant_exchange

OVERSAMPLE = 32  # samples per device; bucket size <= m + n/(D*OVERSAMPLE)


def _lex_less(a: Sequence[jax.Array], b: Sequence[jax.Array]) -> jax.Array:
    """a < b lexicographically, elementwise over broadcast shapes."""
    lt = jnp.zeros(jnp.broadcast_shapes(a[0].shape, b[0].shape), dtype=bool)
    eq = jnp.ones_like(lt)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def _bucket_of(keys: Sequence[jax.Array], splitters: Sequence[jax.Array]):
    """Destination bucket per element: #splitters <= key (splitters sorted).

    splitters: tuple of [D-1] arrays.  Cost O(m * (D-1)) compares — fine for
    small D; switch to batched binary search for very wide meshes.
    """
    m = keys[0].shape[0]
    ks = [k[:, None] for k in keys]
    ss = [s[None, :] for s in splitters]
    # splitter < key  -> key belongs to a bucket at least one past it
    return jnp.sum(_lex_less(ss, ks), axis=1).astype(jnp.int32)


def dist_sort(
    keys: Sequence[jax.Array],
    payload: Sequence[jax.Array],
    axis: str,
    cap: int,
    key: jax.Array = None,
):
    """Globally sort (keys, payload) across the mesh axis; each device ends
    with exactly its equal block of the global order.

    keys/payload: per-device [m] int32 arrays (call inside shard_map).  The
    key tuple must be globally unique per element.  `key` (PRNG) enables
    the Valiant two-hop bucket exchange, which bounds per-pair load at
    ~m/D even when a source block is entirely inside one bucket (clustered
    data, pad blocks); without it the dense exchange needs cap >= m to be
    skew-proof.  Returns (sorted_keys, sorted_payload, overflow); overflow
    > 0 signals a capacity retry is needed.
    """
    D = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    m = keys[0].shape[0]
    nk = len(keys)
    cols = list(keys) + list(payload)

    if D == 1:
        # a 1-device mesh degenerates to ONE local sort — skip the
        # splitter/exchange/rebalance machinery and its padded buffers
        # entirely; axis_size is static so this branch compiles away)
        out = list(jax.lax.sort(tuple(cols), num_keys=nk))
        return out[:nk], out[nk:], jnp.int32(0)

    # ---- pass 1: local sort ----
    cols = list(jax.lax.sort(tuple(cols), num_keys=nk))
    skeys = cols[:nk]

    # ---- splitters from evenly spaced local samples ----
    S = min(OVERSAMPLE, m)
    samp_idx = (jnp.arange(S, dtype=jnp.int32) * m) // S
    samples = [k[samp_idx] for k in skeys]  # [S]
    gathered = [jax.lax.all_gather(s, axis).reshape(-1) for s in samples]
    gathered = list(jax.lax.sort(tuple(gathered), num_keys=nk))  # [D*S]
    spl_idx = (jnp.arange(D - 1, dtype=jnp.int32) + 1) * S
    splitters = [g[spl_idx] for g in gathered]

    # ---- route to buckets ----
    dest = _bucket_of(skeys, splitters)
    if key is None:
        received, rvalid, overflow1 = exchange(dest, cols, cap, axis)
    else:
        received, rvalid, overflow1 = valiant_exchange(
            dest, cols, cap, axis, key
        )
    received = list(received)

    # ---- pass 2: local sort of received (invalid lanes to the end) ----
    for i in range(nk):
        received[i] = jnp.where(rvalid, received[i], INT32_MAX)
    received = list(jax.lax.sort(tuple(received), num_keys=nk))
    v = jnp.sum(rvalid).astype(jnp.int32)

    # ---- exact rebalance to equal blocks of m ----
    # Bucket balance (regular sampling with OVERSAMPLE) keeps each device's
    # received global range within a few blocks of its own, so the
    # redistribution is a small static window of ppermute shifts — no
    # all_to_all capacity risk.  W=3 covers D <= 3*OVERSAMPLE meshes.
    counts = jax.lax.all_gather(v, axis)  # [D]
    base = jnp.sum(jnp.where(jnp.arange(D) < me, counts, 0)).astype(jnp.int32)
    i_local = jnp.arange(received[0].shape[0], dtype=jnp.int32)
    gpos = base + i_local
    valid = i_local < v
    owner = jnp.where(valid, gpos // m, -INT32_MAX)
    W = min(3, D - 1)
    outs = [jnp.full((m,), INT32_MAX, dtype=jnp.int32) for _ in received]
    covered = jnp.zeros((m,), dtype=bool)
    for off in range(-W, W + 1):
        sel = valid & (owner == me + off)
        p = jnp.where(sel, gpos - (me + off) * m, m)  # dest-local position
        bufs = []
        vbuf = jnp.zeros((m,), dtype=bool).at[p].set(sel, mode="drop")
        for rec in received:
            bufs.append(
                jnp.zeros((m,), dtype=rec.dtype).at[p].set(rec, mode="drop")
            )
        if off != 0:
            perm = [(i, (i + off) % D) for i in range(D)]
            vbuf = jax.lax.ppermute(vbuf, axis, perm)
            bufs = [jax.lax.ppermute(b, axis, perm) for b in bufs]
        outs = [jnp.where(vbuf, b, o) for b, o in zip(bufs, outs)]
        covered = covered | vbuf
    # any element owned outside the window → rebalance failure (overflow)
    out_of_window = valid & (jnp.abs(owner - me) > W)
    overflow2 = jax.lax.pmax(
        jnp.max(jnp.where(out_of_window, 1, 0)), axis
    ).astype(jnp.int32)

    overflow = jnp.maximum(overflow1, overflow2)
    return outs[:nk], outs[nk:], overflow
