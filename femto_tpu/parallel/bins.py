"""Record exchange over the device mesh — the collective replacement for MPI bins.

The reference moves fixed-size big-endian records between MPI ranks through
tile pipes feeding per-bin two-pass sorters
(/root/reference/src/dcx_cc/dcx.hh:884-935, src/mpi/mpi_utils.hh:148-295).
Here a "bin" is a device's equal block of a sharded array, and record
movement is a dense `all_to_all` with static per-pair capacity:

  * every function in this module runs INSIDE `jax.shard_map` over a 1-D
    mesh axis;
  * senders bucket records by destination device, lay them out in a
    [D, cap] buffer (pad = sentinel), and one `all_to_all` delivers all
    buckets — the analog of an MPI_Alltoallv with capacity-padded tiles;
  * skew beyond `cap` cannot be expressed in static shapes, so exchanges
    report an `overflow` scalar (max bucket excess); callers check it on
    the host and retry with a larger capacity.  Correctness is never
    silent-dropped.

`exchange_by_owner` is the common special case "route element to the device
owning global position p" (p // m), whose receive sizes are exactly balanced.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

INT32_MAX = jnp.iinfo(jnp.int32).max


def _axis_size(axis: str) -> int:
    return jax.lax.axis_size(axis)


def exchange(
    dest: jax.Array,
    records: Sequence[jax.Array],
    cap: int,
    axis: str,
    valid: jax.Array | None = None,
):
    """Route records[i] to device dest[i].

    dest: int32[m] in [0, D); records: arrays of shape [m] (any int dtype);
    valid: optional bool[m] — invalid lanes are not sent.

    Returns (received, recv_valid, overflow):
      received:   tuple of [D*cap] arrays, grouped by source device;
      recv_valid: bool[D*cap];
      overflow:   int32 scalar, max over destinations of (bucket - cap);
                  > 0 means records were dropped — caller must retry with
                  a larger cap.
    """
    D = _axis_size(axis)
    m = dest.shape[0]
    if valid is None:
        valid = jnp.ones((m,), dtype=bool)
    dest = jnp.where(valid, dest, D)  # route invalid lanes nowhere

    order = jnp.argsort(dest, stable=True)
    dsort = dest[order]
    # per-destination counts and bucket start offsets
    counts = jnp.zeros((D + 1,), jnp.int32).at[dsort].add(1)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    pos = jnp.arange(m, dtype=jnp.int32) - starts[dsort]
    in_cap = (pos < cap) & (dsort < D)
    slot = jnp.where(in_cap, dsort * cap + pos, D * cap)  # OOB -> dropped

    send_valid = (
        jnp.zeros((D * cap,), dtype=bool).at[slot].set(True, mode="drop")
    )
    sent = []
    for rec in records:
        r = rec[order]
        buf = jnp.zeros((D * cap,), dtype=rec.dtype).at[slot].set(
            r, mode="drop"
        )
        sent.append(
            jax.lax.all_to_all(
                buf.reshape(D, cap), axis, split_axis=0, concat_axis=0,
                tiled=True,
            ).reshape(D * cap)
        )
    recv_valid = jax.lax.all_to_all(
        send_valid.reshape(D, cap), axis, split_axis=0, concat_axis=0,
        tiled=True,
    ).reshape(D * cap)
    overflow = jax.lax.pmax(jnp.max(counts[:D]) - cap, axis)
    return tuple(sent), recv_valid, overflow


def valiant_exchange(
    dest: jax.Array,
    records: Sequence[jax.Array],
    cap: int,
    axis: str,
    key: jax.Array,
    valid: jax.Array | None = None,
):
    """Two-hop randomized (Valiant) exchange: each record first hops to a
    uniformly random intermediate device, then to its destination.

    Dense all_to_all needs a static per-(src,dst) capacity; a skewed or
    position-correlated destination map (e.g. scattering sorted records back
    to position order) can concentrate ~m records on one pair.  Random
    intermediates split every pair's load ~m/D per hop w.h.p., so
    cap ≈ 3*m/D suffices regardless of input structure.  Overflow is still
    detected and reported for host-side retry (with a fresh key).

    key: per-call PRNG key (fold in axis_index for per-device streams).
    """
    D = _axis_size(axis)
    m = dest.shape[0]
    if valid is None:
        valid = jnp.ones((m,), dtype=bool)
    me = jax.lax.axis_index(axis)
    k = jax.random.fold_in(key, me)
    inter = jax.random.randint(k, (m,), 0, D, dtype=jnp.int32)
    # hop 1: carry (dest, records) to the random intermediate
    recs1, v1, of1 = exchange(inter, [dest] + list(records), cap, axis, valid)
    # hop 2: forward to the true destination
    recs2, v2, of2 = exchange(recs1[0], recs1[1:], cap, axis, v1)
    return recs2, v2, jnp.maximum(of1, of2)


def exchange_by_owner(
    gpos: jax.Array,
    records: Sequence[jax.Array],
    m_owner: int,
    cap: int,
    axis: str,
    valid: jax.Array | None = None,
):
    """Route each record to the device owning global position gpos[i]
    (owner = gpos // m_owner).  Returns (received_positions_local,
    received_records, recv_valid, overflow)."""
    owner = (gpos // m_owner).astype(jnp.int32)
    recs = [gpos] + list(records)
    received, recv_valid, overflow = exchange(owner, recs, cap, axis, valid)
    lpos = received[0] - jax.lax.axis_index(axis) * m_owner
    return lpos, tuple(received[1:]), recv_valid, overflow


def place_by_owner(
    gpos: jax.Array,
    records: Sequence[jax.Array],
    m_owner: int,
    cap: int,
    axis: str,
    fills: Sequence[jax.Array],
    valid: jax.Array | None = None,
):
    """Exchange records to position owners and scatter them into dense
    local blocks: out[r][gpos % m_owner] = records[r].  `fills` provides a
    [m_owner] default array per record.  Every global position must be
    covered at most once.  Returns (outs, overflow)."""
    lpos, recs, rvalid, overflow = exchange_by_owner(
        gpos, records, m_owner, cap, axis, valid
    )
    idx = jnp.where(rvalid, lpos, m_owner)
    outs = []
    for rec, fill in zip(recs, fills):
        outs.append(fill.at[idx].set(rec, mode="drop"))
    return tuple(outs), overflow
