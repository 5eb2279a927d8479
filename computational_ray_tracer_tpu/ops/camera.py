"""Cameras: batched pure-function ray generation.

Capability parity with ``RayTracer/Cameras.h:77-423`` (CameraBase basis/matrix
handling, Orthographic, Perspective with thin-lens depth of field, Pinhole
box camera, physical Thinlens), array-first: a camera is a frozen config whose
matrices are precomputed host-side; ``generate_rays(pixel_xy, u_lens)`` is a
pure vectorized map from raster coordinates + lens uniforms to world-space
ray origins/directions, vmappable and differentiable.

Conventions: camera space is right-handed with the view direction +z and the
image plane at z=+1 (perspective) — the raster y axis points down. World
placement comes from a position + yaw/pitch pair exactly like the reference's
``setyawpitch`` (Cameras.h:121-128) or a look-at constructor.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import sampling as smp


def yaw_pitch_basis(yaw, pitch):
    """look/right/up from yaw/pitch degrees (Cameras.h:121-128)."""
    cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
    cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
    look = np.array([cy * cp, sp, sy * cp])
    look /= np.linalg.norm(look)
    world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(world_up, look)
    if np.linalg.norm(right) < 1e-8:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(look, right)
    return look, right, up


def look_at_basis(eye, target, up=(0.0, 1.0, 0.0)):
    look = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    look /= np.linalg.norm(look)
    right = np.cross(np.asarray(up, np.float64), look)
    right /= np.linalg.norm(right)
    true_up = np.cross(look, right)
    return look, right, true_up


@dataclasses.dataclass(frozen=True)
class CameraBase:
    """Shared film geometry + world placement (calculateWorldCameraMatrices,
    Cameras.h:130-157). Subclasses implement ``_rays_camera_space``."""
    position: tuple
    basis: tuple           # (look, right, up) rows, world space
    resolution: tuple      # (W, H)

    @property
    def _world_rot(self):
        look, right, up = self.basis
        # camera->world: columns are right/up/look (x, y, z axes)
        return np.stack([np.asarray(right), np.asarray(up),
                         np.asarray(look)], axis=1)

    def _to_world(self, o_cam, d_cam):
        m = jnp.asarray(self._world_rot, jnp.float32)
        pos = jnp.asarray(self.position, jnp.float32)
        o = jnp.einsum("ij,...j->...i", m, o_cam, precision="highest") + pos
        d = jnp.einsum("ij,...j->...i", m, d_cam, precision="highest")
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return o, d

    def _ndc(self, pixel_xy):
        w, h = self.resolution
        x = pixel_xy[..., 0] / w
        y = pixel_xy[..., 1] / h
        return x, y

    def generate_rays(self, pixel_xy, u_lens):
        """(..., 2) raster coords + (..., 2) lens uniforms -> (o, d) world."""
        o_cam, d_cam = self._rays_camera_space(pixel_xy, u_lens)
        return self._to_world(o_cam, d_cam)


def _make(cls, position, resolution, yaw=0.0, pitch=0.0, look_at=None,
          **kw):
    if look_at is not None:
        basis = look_at_basis(position, look_at)
    else:
        basis = yaw_pitch_basis(yaw, pitch)
    return cls(position=tuple(position),
               basis=tuple(tuple(b) for b in basis),
               resolution=tuple(resolution), **kw)


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera(CameraBase):
    """Pinhole-projection camera with optional thin-lens DoF
    (Cameras.h:248-310; lens sampling at :281-291). fov_y in degrees."""
    fov_y: float = 45.0
    lens_radius: float = 0.0
    focal_distance: float = 1e6

    @classmethod
    def create(cls, position, resolution, fov_y=45.0, lens_radius=0.0,
               focal_distance=1e6, **kw):
        return _make(cls, position, resolution, fov_y=fov_y,
                     lens_radius=lens_radius, focal_distance=focal_distance,
                     **kw)

    def _rays_camera_space(self, pixel_xy, u_lens):
        w, h = self.resolution
        aspect = w / h
        tan_half = math.tan(math.radians(self.fov_y) / 2.0)
        nx, ny = self._ndc(pixel_xy)
        sx = (2.0 * nx - 1.0) * tan_half * aspect
        sy = (1.0 - 2.0 * ny) * tan_half
        d = jnp.stack([sx, sy, jnp.ones_like(sx)], axis=-1)
        o = jnp.zeros_like(d)
        if self.lens_radius > 0.0:
            p_lens = smp.sample_uniform_disk_concentric(u_lens,
                                                        self.lens_radius)
            ft = self.focal_distance  # z distance to focal plane
            p_focus = d * ft  # d.z == 1, so this lands on z = ft
            o = jnp.concatenate([p_lens, jnp.zeros_like(sx)[..., None]],
                                axis=-1)
            d = p_focus - o
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return o, d


@dataclasses.dataclass(frozen=True)
class OrthographicCamera(CameraBase):
    """Parallel-ray camera over a width x height window (Cameras.h:213-245)."""
    window: tuple = (2.0, 2.0)  # world-space (width, height) of the film

    @classmethod
    def create(cls, position, resolution, window=(2.0, 2.0), **kw):
        return _make(cls, position, resolution, window=tuple(window), **kw)

    def _rays_camera_space(self, pixel_xy, u_lens):
        nx, ny = self._ndc(pixel_xy)
        ww, wh = self.window
        x = (2.0 * nx - 1.0) * ww / 2.0
        y = (1.0 - 2.0 * ny) * wh / 2.0
        o = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
        d = jnp.stack([jnp.zeros_like(x), jnp.zeros_like(x),
                       jnp.ones_like(x)], axis=-1)
        return o, d


@dataclasses.dataclass(frozen=True)
class PinholeCamera(CameraBase):
    """Physical pinhole box: sensor plane behind a finite-radius hole
    (Cameras.h:313-359). A zero-radius hole is an ideal (inverted) pinhole;
    a finite radius produces the reference's box-camera blur."""
    sensor_size: tuple = (0.036, 0.024)   # (width, height), world units
    sensor_distance: float = 0.05
    hole_radius: float = 0.0

    @classmethod
    def create(cls, position, resolution, sensor_size=(0.036, 0.024),
               sensor_distance=0.05, hole_radius=0.0, **kw):
        return _make(cls, position, resolution, sensor_size=tuple(sensor_size),
                     sensor_distance=sensor_distance, hole_radius=hole_radius,
                     **kw)

    def _rays_camera_space(self, pixel_xy, u_lens):
        nx, ny = self._ndc(pixel_xy)
        sw, sh = self.sensor_size
        # Sensor sits behind the hole; image inverts through the aperture, so
        # flip raster coords to produce an upright image.
        px = (1.0 - 2.0 * nx) * sw / 2.0
        py = (2.0 * ny - 1.0) * sh / 2.0
        p_sensor = jnp.stack([px, py,
                              jnp.full_like(px, -self.sensor_distance)],
                             axis=-1)
        if self.hole_radius > 0.0:
            p_hole2 = smp.sample_uniform_disk_concentric(u_lens,
                                                         self.hole_radius)
        else:
            p_hole2 = jnp.zeros_like(p_sensor[..., :2])
        p_hole = jnp.concatenate(
            [p_hole2, jnp.zeros_like(p_sensor[..., :1])], axis=-1)
        d = p_hole - p_sensor
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return p_hole, d


@dataclasses.dataclass(frozen=True)
class ThinLensCamera(CameraBase):
    """Physically parameterized thin lens (Cameras.h:362-409): biconvex lens
    of curvature radius R and index n (lensmaker focal length), aperture
    diameter, focused at ``focus_distance`` via the conjugate equation."""
    lens_radius_of_curvature: float = 0.5
    lens_ior: float = 1.5
    aperture_radius: float = 0.01
    focus_distance: float = 2.0
    sensor_size: tuple = (0.036, 0.024)

    @classmethod
    def create(cls, position, resolution, lens_radius_of_curvature=0.5,
               lens_ior=1.5, aperture_radius=0.01, focus_distance=2.0,
               sensor_size=(0.036, 0.024), **kw):
        return _make(cls, position, resolution,
                     lens_radius_of_curvature=lens_radius_of_curvature,
                     lens_ior=lens_ior, aperture_radius=aperture_radius,
                     focus_distance=focus_distance,
                     sensor_size=tuple(sensor_size), **kw)

    @property
    def focal_length(self):
        # Lensmaker, biconvex symmetric: 1/f = (n-1) * 2/R
        return 1.0 / ((self.lens_ior - 1.0) *
                      2.0 / self.lens_radius_of_curvature)

    @property
    def image_distance(self):
        f = self.focal_length
        so = self.focus_distance
        return 1.0 / max(1.0 / f - 1.0 / so, 1e-9)

    def _rays_camera_space(self, pixel_xy, u_lens):
        nx, ny = self._ndc(pixel_xy)
        sw, sh = self.sensor_size
        si = self.image_distance
        so = self.focus_distance
        # Sensor behind the lens (z = -si), image inverted through the lens.
        px = (1.0 - 2.0 * nx) * sw / 2.0
        py = (2.0 * ny - 1.0) * sh / 2.0
        # Conjugate (in-focus) object point via magnification m = -so/si.
        mag = so / si
        p_obj = jnp.stack([-px * mag, -py * mag, jnp.full_like(px, so)],
                          axis=-1)
        p_lens2 = smp.sample_uniform_disk_concentric(u_lens,
                                                     self.aperture_radius)
        o = jnp.concatenate([p_lens2, jnp.zeros_like(px)[..., None]], axis=-1)
        d = p_obj - o
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return o, d
