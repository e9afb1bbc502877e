"""Stateless counter-based RNG for the wavefront loop.

The reference seeds a thrust engine per (iter, thread index, depth) via a hash
(reference src/pathtrace.cu:69-74, src/intersections.h:12-21) and consumes it
sequentially. Two stateless equivalents:

  fast (default)   A PCG-style integer hash of (seed, iteration, depth, lane,
                   draw) — raw uint32 elementwise ops, ~10 int ops per word.
                   This is the same construction as the reference's
                   utilhash-seeded thrust::default_random_engine (a cheap
                   LCG), with far better mixing, and much cheaper than
                   threefry's rounds.

  threefry         jax.random keys (cryptographic-grade counter RNG). Kept
                   for A/B validation of the fast hash and for users who want
                   jax-standard streams.

Both are fully deterministic functions of (seed, iteration, depth, lane),
independent of scheduling/sharding — per-ray streams are distribution-
equivalent to the reference, not bit-equivalent (SURVEY.md §7c).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

GOLDEN = jnp.uint32(0x9E3779B9)


# ---------------------------------------------------------------------------
# Fast path: PCG hash (pcg_hash from pcg-random.org, output fn PCG-RXS-M-XS)
# ---------------------------------------------------------------------------

def _pcg(x: jnp.ndarray) -> jnp.ndarray:
    """One round of PCG-RXS-M-XS on uint32 — 8 integer ops."""
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    x = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) * jnp.uint32(277803737)
    return (x >> jnp.uint32(22)) ^ x


def _to_unit(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> f32 in [0, 1): top 24 bits scaled."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def fast_state(seed, iteration) -> jnp.ndarray:
    """uint32 stream state for one iteration (scalar)."""
    s = jnp.uint32(seed) * GOLDEN + jnp.asarray(iteration).astype(jnp.uint32)
    return _pcg(s)


def fast_fold(state: jnp.ndarray, salt) -> jnp.ndarray:
    """Derive a sub-stream (per bounce / per shard)."""
    return _pcg(state ^ (jnp.asarray(salt).astype(jnp.uint32) * GOLDEN))


def fast_uniforms(state: jnp.ndarray, n: int, m: int) -> jnp.ndarray:
    """[n, m] uniforms in [0, 1) from the hash stream."""
    lane = jax.lax.broadcasted_iota(jnp.uint32, (n, m), 0)
    draw = jax.lax.broadcasted_iota(jnp.uint32, (n, m), 1)
    return _to_unit(_pcg(lane ^ _pcg(draw * GOLDEN + state)))


def _box_muller(u: jnp.ndarray, m: int) -> jnp.ndarray:
    """[n, 2k] uniforms -> [n, m] standard normals."""
    u1 = jnp.maximum(u[:, 0::2], 1e-12)
    u2 = u[:, 1::2]
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = (2.0 * jnp.pi) * u2
    out = jnp.concatenate([r * jnp.cos(theta), r * jnp.sin(theta)], axis=1)
    return out[:, :m]


def fast_normals(state: jnp.ndarray, n: int, m: int) -> jnp.ndarray:
    """[n, m] standard normals via Box-Muller on hash uniforms."""
    return _box_muller(fast_uniforms(state, n, 2 * ((m + 1) // 2)), m)


def decision_state(seed, sample, depth, pixel: jnp.ndarray) -> jnp.ndarray:
    """[n] uint32 stream states keyed on (seed, sample, depth, pixel).

    THE canonical per-decision stream of the fast path: every random decision
    in the renderer is keyed by which pixel's which sample is at which bounce
    — the same construction as the reference's makeSeededRandomEngine(iter,
    index, depth) (pathtrace.cu:69-74) with a stronger mixer. Because the key
    is (pixel, sample, depth) — never the lane or shard — every engine
    (masked / sorted / persistent) and every sharding draws IDENTICAL numbers
    for the same logical sample, so cross-engine images match exactly (up to
    accumulation-order float rounding).

    `sample` and `depth` may be scalars (wavefront engine: whole pool at one
    iteration/bounce) or [n] arrays (persistent engine: per-lane schedules).
    Raygen uses the reserved depth values -1 (AA jitter) and -2 (DoF lens).
    """
    h = _pcg(jnp.uint32(seed) * GOLDEN
             + jnp.asarray(sample).astype(jnp.uint32))
    h = _pcg(h ^ (jnp.asarray(depth).astype(jnp.uint32)
                  * jnp.uint32(0x85EBCA6B)))
    return _pcg(h ^ (pixel.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35)))


def fast_uniforms_perlane(state: jnp.ndarray, m: int):
    """m separate [n] uniform arrays from per-lane uint32 states [n].

    Returned as a TUPLE of 1-D arrays, not an [n, m] matrix: profiling showed
    the matrix layout (T(4,128)) made the consumer's column slices the single
    most expensive fusion of the frame (24%); per-draw 1-D arrays are pure
    elementwise lanes. Draw j is bitwise-identical to the old column j.
    """
    return tuple(_to_unit(_pcg(state + jnp.uint32(j) * GOLDEN))
                 for j in range(m))


def fast_normals_perlane(state: jnp.ndarray, m: int):
    """m separate [n] standard-normal arrays from per-lane states."""
    u = fast_uniforms_perlane(state, 2 * ((m + 1) // 2))
    out = []
    for k in range(0, len(u), 2):
        u1 = jnp.maximum(u[k], 1e-12)
        r = jnp.sqrt(-2.0 * jnp.log(u1))
        theta = (2.0 * jnp.pi) * u[k + 1]
        out.extend([r * jnp.cos(theta), r * jnp.sin(theta)])
    return tuple(out[:m])


# ---------------------------------------------------------------------------
# jax.random path
# ---------------------------------------------------------------------------

def iteration_key(seed: jnp.ndarray | int, iteration: jnp.ndarray) -> jax.Array:
    """Key for one progressive-render iteration."""
    base = jax.random.key(seed) if isinstance(seed, int) else seed
    return jax.random.fold_in(base, iteration)


def bounce_key(iter_key: jax.Array, depth: jnp.ndarray) -> jax.Array:
    """Key for one bounce within an iteration."""
    return jax.random.fold_in(iter_key, depth)


def uniforms(key: jax.Array, n: int, m: int) -> jnp.ndarray:
    """[n, m] uniforms in [0, 1)."""
    return jax.random.uniform(key, (n, m), dtype=jnp.float32)


def normals(key: jax.Array, n: int, m: int) -> jnp.ndarray:
    """[n, m] standard normals."""
    return jax.random.normal(key, (n, m), dtype=jnp.float32)


# ---------------------------------------------------------------------------
# Unified stream facade: trace-time static choice between the two
# ---------------------------------------------------------------------------

def _u32_salt(depth):
    """fold_in rejects negative Python ints (raygen channels -1/-2)."""
    if isinstance(depth, int) and depth < 0:
        return depth & 0xFFFFFFFF
    return depth


class IterationRng:
    """Per-iteration RNG facade for the wavefront engines.

    fast mode: draws come from decision_state(seed, iteration, depth, PIXEL)
    — engine-, lane- and shard-independent (pixel ids are globally unique, so
    `key_salt` is ignored). threefry mode: jax.random streams folded per
    (iteration, salt, depth), assigned by lane row (reference-style).
    """

    __slots__ = ("fast", "seed", "iteration", "offset", "stream",
                 "pixel_map")

    def __init__(self, fast: bool, seed, iteration, pixel_offset=0,
                 key_salt=None, pixel_map=None):
        self.fast = fast
        self.pixel_map = pixel_map if pixel_map is not None else (
            lambda lane: lane)
        if fast:
            self.seed = seed
            self.iteration = iteration
            self.offset = pixel_offset
        else:
            self.stream = Stream.for_iteration(False, seed, iteration,
                                               salt=key_salt)

    def uniforms(self, depth, pixel_local: jnp.ndarray, m: int,
                 salt=None):
        """m separate [n] uniform arrays for lanes at `pixel_local` (+offset).

        depth: bounce index, or the reserved raygen channels -1 (AA) / -2
        (DoF lens). `salt` only affects the threefry path (e.g. the tiled
        mode's per-tile sub-streams); the fast path is already unique per
        (pixel, depth).
        """
        if self.fast:
            st = decision_state(self.seed, self.iteration, depth,
                                self.pixel_map(pixel_local + self.offset))
            return fast_uniforms_perlane(st, m)
        s = self.stream.fold(_u32_salt(depth))
        if salt is not None:
            s = s.fold(salt)
        u = s.uniforms(pixel_local.shape[0], m)
        return tuple(u[:, j] for j in range(m))

    def normals(self, depth, pixel_local: jnp.ndarray, m: int) -> jnp.ndarray:
        if self.fast:
            st = decision_state(self.seed, self.iteration, depth,
                                self.pixel_map(pixel_local + self.offset))
            return fast_normals_perlane(st, m)
        z = self.stream.fold(_u32_salt(depth)).normals(
            pixel_local.shape[0], m)
        return tuple(z[:, j] for j in range(m))


class Stream:
    """One iteration's RNG stream; `fast` is static at trace time."""

    __slots__ = ("fast", "state")

    def __init__(self, fast: bool, state):
        self.fast = fast
        self.state = state

    @classmethod
    def for_iteration(cls, fast: bool, seed, iteration, salt=None) -> "Stream":
        if fast:
            st = fast_state(seed, iteration)
            if salt is not None:
                st = fast_fold(st, salt)
        else:
            st = iteration_key(seed, iteration)
            if salt is not None:
                st = jax.random.fold_in(st, salt)
        return cls(fast, st)

    def fold(self, salt) -> "Stream":
        if self.fast:
            return Stream(True, fast_fold(self.state, salt))
        return Stream(False, jax.random.fold_in(self.state, salt))

    def uniforms(self, n: int, m: int) -> jnp.ndarray:
        return (fast_uniforms if self.fast else uniforms)(self.state, n, m)

    def normals(self, n: int, m: int) -> jnp.ndarray:
        return (fast_normals if self.fast else normals)(self.state, n, m)
