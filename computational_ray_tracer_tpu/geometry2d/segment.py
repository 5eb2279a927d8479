"""Segment predicates, batched.

Capability parity with ``Geometry/Segment.h:4-163`` (orientation/turn tests,
segment-segment intersection with and without boundary, point-segment and
point-triangle distance, line-line intersection), array-first: every predicate
is an elementwise jnp function over arrays of points/segments, usable both
on device (batch) and on host scalars."""

from __future__ import annotations

import jax.numpy as jnp


def orientation(a, b, c):
    """Signed twice-area of triangle abc: >0 left turn (CCW), <0 right."""
    return ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def is_left_turn(a, b, c, eps=0.0):
    return orientation(a, b, c) > eps


def is_right_turn(a, b, c, eps=0.0):
    return orientation(a, b, c) < -eps


def collinear(a, b, c, eps=1e-9):
    return jnp.abs(orientation(a, b, c)) <= eps


def on_segment(p, a, b, eps=1e-7):
    """Is p on segment ab (inclusive)?"""
    col = jnp.abs(orientation(a, b, p)) <= eps * (
        1.0 + jnp.abs(p).sum(-1) + jnp.abs(a).sum(-1) + jnp.abs(b).sum(-1))
    within = ((p[..., 0] >= jnp.minimum(a[..., 0], b[..., 0]) - eps)
              & (p[..., 0] <= jnp.maximum(a[..., 0], b[..., 0]) + eps)
              & (p[..., 1] >= jnp.minimum(a[..., 1], b[..., 1]) - eps)
              & (p[..., 1] <= jnp.maximum(a[..., 1], b[..., 1]) + eps))
    return col & within


def segments_intersect(a, b, c, d, include_endpoints=True):
    """Do segments ab and cd intersect (Segment.h intersection predicates)?

    ``include_endpoints=False`` requires proper (interior) crossing — the
    reference's 'without boundary' variant."""
    d1 = orientation(c, d, a)
    d2 = orientation(c, d, b)
    d3 = orientation(a, b, c)
    d4 = orientation(a, b, d)
    proper = (((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0))) & \
             (((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0)))
    if not include_endpoints:
        return proper
    touch = (on_segment(a, c, d) | on_segment(b, c, d)
             | on_segment(c, a, b) | on_segment(d, a, b))
    return proper | touch


def line_line_intersection(a, b, c, d):
    """Intersection point of infinite lines ab and cd.
    Returns (point, parallel_mask)."""
    r = b - a
    s = d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    parallel = jnp.abs(denom) < 1e-12
    dn = jnp.where(parallel, 1.0, denom)
    t = ((c[..., 0] - a[..., 0]) * s[..., 1]
         - (c[..., 1] - a[..., 1]) * s[..., 0]) / dn
    p = a + t[..., None] * r
    return p, parallel


def segment_segment_intersection_point(a, b, c, d):
    """Intersection point of segments (valid where they intersect).
    Returns (point, t_ab, u_cd, valid)."""
    r = b - a
    s = d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    parallel = jnp.abs(denom) < 1e-12
    dn = jnp.where(parallel, 1.0, denom)
    qp = c - a
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / dn
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / dn
    valid = (~parallel & (t >= -1e-9) & (t <= 1 + 1e-9)
             & (u >= -1e-9) & (u <= 1 + 1e-9))
    return a + t[..., None] * r, t, u, valid


def point_segment_distance(p, a, b):
    """Euclidean distance from p to segment ab (point SDF capability)."""
    ab = b - a
    denom = jnp.maximum(jnp.sum(ab * ab, axis=-1), 1e-20)
    t = jnp.clip(jnp.sum((p - a) * ab, axis=-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return jnp.linalg.norm(p - proj, axis=-1)


def point_triangle_distance(p, a, b, c):
    """Distance from p to triangle abc (0 inside) — point-triangle SDF."""
    inside = (
        (orientation(a, b, p) >= 0) & (orientation(b, c, p) >= 0)
        & (orientation(c, a, p) >= 0)) | (
        (orientation(a, b, p) <= 0) & (orientation(b, c, p) <= 0)
        & (orientation(c, a, p) <= 0))
    d = jnp.minimum(point_segment_distance(p, a, b),
                    jnp.minimum(point_segment_distance(p, b, c),
                                point_segment_distance(p, c, a)))
    return jnp.where(inside, 0.0, d)
