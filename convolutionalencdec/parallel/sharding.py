"""Sharded encode/decode over a device mesh.

The reference is single-threaded C (SURVEY.md §2 "parallelism — explicitly
absent"); its scaling story is left to "external scripting"
(viterbiDecoder.h:14-16).  Here scaling is first-class:

  * axis "ch" — channel/batch parallelism: independent packets shard
    freely, no communication.
  * axis "tb" — time-block sequence parallelism over ONE long stream:
    the serial ACS recurrence cannot be parallelized exactly, but survivor
    paths merge within ~5K trellis steps (the truncation argument the
    reference's author writes out at viterbiDecoder.c:53-74), so each time
    block decodes its slice after a W-step warm-up from uniform metrics
    and a W-step warm-down before traceback (overlap-save).  The W-segment
    halos move between neighbor devices with `jax.lax.ppermute` inside
    `shard_map`.

Exactness: block 0 keeps the true initial metrics (state 0 = 0, others
"forceNot") and the last block tracebacks from the true terminal state 0;
interior blocks use uniform metrics + argmin-state traceback.  Warm-up
steps are masked to identity (metrics pass through unchanged) so boundary
conditions are exact, and the decoded bits equal the unsharded decoder's
everywhere survivor paths merge within W — guaranteed in practice for
W >> 5K below the code's correction limit (near/above it the reference's
own catastrophic-failure caveat applies, viterbiDecoder.c:68-74).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..params import CodeSpec
from ..ops.trellis import butterfly_coded_bits
from ..ops.viterbi import init_metric_value

#: Default warm-up/warm-down length in trellis steps — comfortably above
#: the 5K-step survivor merge distance (TRACEBACK_LEN, viterbiDecoder.h:19;
#: 35 for K=7, so ~3.7x margin here; the block-decoder variant uses 144).
DEFAULT_WARMUP = 128


def _halo_extend(seg_local, W: int, ntb: int):
    """Overlap-save halo exchange over the "tb" mesh axis: prepend the
    previous block's last W steps and append the next block's first W
    (zero context at the outer edges).  THE single copy of the ppermute
    block — both time-sharded decoders use it."""
    if ntb > 1:
        left = jax.lax.ppermute(
            seg_local[:, -W:], "tb",
            perm=[(j, j + 1) for j in range(ntb - 1)])
        right = jax.lax.ppermute(
            seg_local[:, :W], "tb",
            perm=[(j + 1, j) for j in range(ntb - 1)])
        return jnp.concatenate([left, seg_local, right], axis=1)
    z = jnp.zeros((seg_local.shape[0], W), seg_local.dtype)
    return jnp.concatenate([z, seg_local, z], axis=1)


def make_mesh(n_channel_shards: int, n_time_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (ch, tb) mesh.  ch x tb must equal the device count."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = n_channel_shards * n_time_shards
    if devices.size != total:
        raise ValueError(
            f"mesh {n_channel_shards}x{n_time_shards} needs {total} devices, "
            f"have {devices.size}")
    return Mesh(devices.reshape(n_channel_shards, n_time_shards),
                axis_names=("ch", "tb"))


def _scan_impl(spec, segments, valid, init_m):
    """Butterfly ACS where invalid steps are identity (metrics unchanged).

    Args:
      segments: uint8 [T] hard segments.
      valid: bool [T]; False steps leave metrics untouched (their decisions
        are emitted but are never reached by a traceback that stays inside
        the valid region).
      init_m: int32 [NS] initial path metrics.
    Returns (final_metrics int32 [NS], decisions uint8 [T, NS]).
    """
    NS = spec.num_states
    half = NS // 2
    bfly = butterfly_coded_bits(spec)
    cbits = jnp.asarray(
        np.stack([(bfly >> j) & 1 for j in range(spec.n)]).astype(np.int32))

    def step(m, inp):
        seg, ok = inp
        rbits = jnp.stack([(seg >> j) & 1 for j in range(spec.n)])
        em = jnp.sum(cbits ^ rbits[:, None], axis=0)
        emc = spec.n - em
        m_lo, m_hi = m[:half], m[half:]
        a0, a1 = m_lo + em, m_hi + emc
        b0, b1 = m_lo + emc, m_hi + em
        a_dec = (a0 > a1).astype(jnp.uint8)
        b_dec = (b0 > b1).astype(jnp.uint8)
        new_m = jnp.stack([jnp.minimum(a0, a1), jnp.minimum(b0, b1)],
                          axis=1).reshape(NS)
        dec = jnp.stack([a_dec, b_dec], axis=1).reshape(NS)
        return jnp.where(ok, new_m, m), dec

    return jax.lax.scan(step, jnp.asarray(init_m, jnp.int32),
                        (jnp.asarray(segments, jnp.int32),
                         jnp.asarray(valid)))


def _traceback_masked(spec: CodeSpec, decisions, valid, start_state):
    """Backward walk from `start_state`; invalid steps are identity."""
    shift = (spec.S - 1) * spec.k

    def step(cur, inp):
        dec_t, ok = inp
        e = dec_t[cur].astype(jnp.int32)
        nxt = (cur >> spec.k) | (e << shift)
        bit = (cur & 1).astype(jnp.uint8)
        return jnp.where(ok, nxt, cur), bit

    _, bits = jax.lax.scan(step, jnp.asarray(start_state, jnp.int32),
                           (jnp.asarray(decisions), jnp.asarray(valid)),
                           reverse=True)
    return bits


def block_decode(spec: CodeSpec, segments, valid, init_m, tb_state):
    """Decode one overlap-extended block: masked forward + masked traceback.

    Returns uint8 [T] bits (bit t is meaningful where `valid[t]`)."""
    final_m, decisions = _scan_impl(spec, segments, valid, init_m)
    start = jnp.where(tb_state >= 0, tb_state,
                      jnp.argmin(final_m).astype(jnp.int32))
    return _traceback_masked(spec, decisions, valid, start)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def decode_sharded(spec: CodeSpec, segments, mesh: Mesh,
                   warmup: int = DEFAULT_WARMUP):
    """Hard-decision block decode sharded over a (ch, tb) mesh.

    Args:
      segments: uint8 [B, T] terminated packets; B divisible by the "ch"
        axis size, T by the "tb" axis size.
    Returns:
      uint8 [B, T] decoded bits per trellis step; bits [0, T-S) are the
      message (the caller slices, as `viterbi_decode_batch` does).
    """
    spec.validate_for_butterfly()
    segments = jnp.asarray(segments, jnp.uint8)
    B, T = segments.shape
    nch = mesh.shape["ch"]
    ntb = mesh.shape["tb"]
    if B % nch or T % ntb:
        raise ValueError(f"B={B} %{nch} or T={T} %{ntb} not shardable")
    W = warmup
    if W > T // ntb:
        # Halos only reach ONE neighbor; a local block shorter than the
        # warm-up would silently clamp the halo slices and desync the
        # valid-mask boundaries (decoding garbage with no error).
        raise ValueError(
            f"warmup {W} exceeds the local block ({T // ntb} steps) — "
            f"use fewer time shards or a shorter warmup")
    NS = spec.num_states
    init_hi = init_metric_value(spec)

    def shard_fn(seg_local):                     # (B/nch, T/ntb)
        i = jax.lax.axis_index("tb")
        last = ntb - 1
        Tl = seg_local.shape[1]
        # Halo exchange: left warm-up context from the previous
        # time block, right warm-down context from the next.
        ext = _halo_extend(seg_local, W, ntb)
        t_idx = jnp.arange(ext.shape[1])
        # Device 0 has no real left context: mask those steps to identity
        # so its initial metrics survive to the true packet start; the last
        # device likewise has no right context.
        valid = jnp.where(
            t_idx < W, i != 0,
            jnp.where(t_idx >= W + Tl, i != last, True))
        s_iota = jnp.arange(NS)
        init_std = jnp.where(s_iota == spec.starting_state, 0, init_hi)
        init_m = jnp.where(i == 0, init_std, jnp.zeros((NS,), jnp.int32))
        # Interior blocks traceback from the argmin state (-1 sentinel);
        # the last block from the known terminal state 0.
        tb_state = jnp.where(i == last, 0, -1)
        # These depend only on the tb coordinate; mark them varying over
        # "ch" too so scan carries type-check under shard_map's
        # varying-manual-axes analysis.
        init_m = jax.lax.pcast(init_m, ("ch",), to="varying")
        tb_state = jax.lax.pcast(tb_state, ("ch",), to="varying")
        valid = jax.lax.pcast(valid, ("ch",), to="varying")
        bits = jax.vmap(
            lambda s: block_decode(spec, s, valid, init_m, tb_state))(ext)
        return bits[:, W:W + Tl]

    from jax import shard_map
    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P("ch", "tb"), out_specs=P("ch", "tb"))
    return fn(segments)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def encode_sharded(spec: CodeSpec, bits, mesh: Mesh, terminate: bool = True):
    """Encode sharded over the channel axis (no communication needed —
    encoding is embarrassingly parallel over packets)."""
    from jax import shard_map
    from ..ops.encode import encode_bits

    def shard_fn(bits_local):
        segs, _ = encode_bits(spec, bits_local, terminate)
        return segs

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P(("ch", "tb"), None),
                   out_specs=P(("ch", "tb"), None))
    return fn(jnp.asarray(bits, jnp.uint8))


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4))
def decode_sharded_batch(spec: CodeSpec, segments, mesh: Mesh,
                         soft: bool = False, interpret: bool = False):
    """Channel-parallel batch decode: independent packets shard over ALL
    mesh devices (both axes flattened) and each device runs the block
    decoder (`kernels.viterbi_decode_batch`) on its local batch — zero
    communication.  Complements `decode_sharded`, which additionally
    shards the TIME axis of long streams (overlap-save).

    Args:
      segments: hard: uint8 [B, T]; soft: int8 [B, T, n] quantized LLRs.
      mesh: any mesh from `make_mesh`; B must be divisible by its total size.
    Returns:
      uint8 [B, T - S] decoded message bits.
    """
    from jax import shard_map
    from ..kernels import viterbi_decode_batch, viterbi_decode_batch_soft

    n_axes = ("ch", "tb")

    def shard_fn(seg_local):
        if soft:
            return viterbi_decode_batch_soft(spec, seg_local,
                                             interpret=interpret)
        return viterbi_decode_batch(spec, seg_local, interpret=interpret)

    extra = (None,) * (jnp.asarray(segments).ndim - 1)
    # check_vma=False: pallas_call outputs don't carry varying-mesh-axes
    # metadata, which the checker otherwise requires.
    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P(n_axes, *extra),
                   out_specs=P(n_axes, None), check_vma=False)
    return fn(jnp.asarray(segments))


def turbo_decode_sharded(llrs, L: int, mesh: Mesh, *, rv: int = 0,
                         n_iters: int = 6):
    """Channel-parallel LTE turbo receive chain under a mesh.

    Independent code blocks shard over ALL mesh devices (both axes
    flattened, like `decode_sharded_batch`); each device runs the full
    derate-match -> iterative max-log-MAP chain (`lte.lte_turbo_decode`)
    on its local batch — zero communication.

    Args:
      llrs: int32 [B, E] received LLRs; B must be divisible by the
        total mesh size.
    Returns:
      uint8 [B, L] decoded bits.
    """
    from jax import shard_map
    from ..ops import lte

    def shard_fn(llrs_local):
        bits, _ = lte.lte_turbo_decode(llrs_local, L, rv=rv,
                                       n_iters=n_iters)
        return bits

    fn = shard_map(shard_fn, mesh=mesh, in_specs=P(("ch", "tb")),
                   out_specs=P(("ch", "tb")), check_vma=False)
    return fn(jnp.asarray(llrs, jnp.int32))


def tbcc_crc_decode_sharded(spec: CodeSpec, crc, qllrs, list_size: int,
                            mesh: Mesh):
    """Channel-parallel CRC-aided tail-biting list receiver under a
    mesh: blocks shard over all devices, each running the full soft
    list-decode + CRC-select chain
    (`ops.tailbiting.viterbi_decode_tailbiting_crc_soft`).  Returns
    (bits [B, L], ok [B])."""
    from jax import shard_map
    from ..ops.tailbiting import viterbi_decode_tailbiting_crc_soft

    def shard_fn(q_local):
        out, ok, _ = viterbi_decode_tailbiting_crc_soft(
            spec, crc, q_local, list_size)
        return out, ok

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P(("ch", "tb"), None, None),
                   out_specs=(P(("ch", "tb"), None), P(("ch", "tb"))),
                   check_vma=False)
    return fn(jnp.asarray(qllrs))


#: Warm-up for the block-decoder time-sharded path, in trellis steps:
#: over 4x the 5K survivor-merge rule for K=7.
DEFAULT_WARMUP_KERNEL = 144


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4))
def decode_sharded_kernel(spec: CodeSpec, segments, mesh: Mesh,
                          warmup: int = DEFAULT_WARMUP_KERNEL,
                          interpret: bool = False):
    """Time-block sharded decode on the block decoder's two operations
    (`kernels.core.acs_forward` and `traceback`).

    Same overlap-save scheme as `decode_sharded` (truncation argument,
    viterbiDecoder.c:53-74), but each device runs the forward over its
    halo-extended block at once instead of a masked scan:

      * every device starts from uniform metrics; device 0 replaces its
        metrics with the exact known start once its (zero) left halo is
        consumed, so its block decodes from the true packet start;
      * interior devices walk back from argmin(final metrics); the last
        device walks from the true terminal state 0 after its last real
        step, ignoring its (zero) right halo;
      * the W-segment halos move between neighbours with
        `jax.lax.ppermute`.

    Bit-exact vs `decode_sharded` (the scan reference) wherever survivor
    paths merge within W.

    Args:
      segments: uint8 [B, T]; T must split into the "tb" axis size.
    Returns:
      uint8 [B, T] decoded bits per trellis step (caller slices [0, L)).
    """
    from ..kernels import core

    spec.validate_for_butterfly()
    segments = jnp.asarray(segments, jnp.uint8)
    B, T = segments.shape
    nch = mesh.shape["ch"]
    ntb = mesh.shape["tb"]
    W = warmup
    if W < spec.S:
        raise ValueError(f"warmup {W} must cover the S={spec.S} "
                         f"termination steps")
    if B % nch:
        raise ValueError(f"B={B} not divisible by ch={nch}")
    if T % ntb:
        raise ValueError(f"T={T} must split into tb={ntb} blocks")
    Tl = T // ntb
    if W > Tl:
        raise ValueError(
            f"warmup {W} exceeds the local block ({Tl} steps) — halos "
            f"only reach one neighbor; use fewer time shards")
    NS = spec.num_states

    def shard_fn(seg_local):                     # (B/nch, Tl)
        i = jax.lax.axis_index("tb")
        last = ntb - 1
        ext = _halo_extend(seg_local, W, ntb)
        Bl, Te = ext.shape                       # Te = 2W + Tl
        dec_l, m = core.acs_forward(
            spec, ext[:, :W], jnp.zeros((Bl, NS), jnp.int32),
            interpret=interpret)
        m = jnp.where(i == 0, core.standard_init(spec, Bl), m)
        dec_r, fm = core.acs_forward(spec, ext[:, W:], m,
                                     interpret=interpret)
        dec = jnp.concatenate([dec_l, dec_r])
        start = jnp.where(i == last, 0,
                          jnp.argmin(fm, axis=1)).astype(jnp.int32)
        end = jnp.full((Bl,), jnp.where(i == last, W + Tl, Te), jnp.int32)
        by = core.traceback(spec, dec, start, end, end,
                            interpret=interpret)
        return core.bytes_to_bits(by, Te)[:, W:W + Tl]

    from jax import shard_map
    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P("ch", "tb"), out_specs=P("ch", "tb"),
                   check_vma=False)
    return fn(segments)
