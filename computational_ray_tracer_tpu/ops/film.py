"""Film: spectral sample accumulation and resolve.

Capability parity with ``RayTracer/Film.h:6-20`` (per-pixel
``{rgbsum, weightsum}`` progressive accumulation) and the resolve path of
``RayTracerTestApp.h:425-452`` (sensor RGB → XYZ → colorspace RGB → sRGB),
array-first: the film is a pytree of ``(H, W, 3)`` + ``(H, W)`` arrays; sample
splats are either an aligned per-pixel sum (the common wavefront layout) or a
scatter-add for free-flight samples. Accumulation is associative, so shards
merge with a single ``psum``/``segment_sum`` (SURVEY §2.6 plan).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import color as colorlib
from computational_ray_tracer_tpu.ops import sensor as sen


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Film:
    """Progressive accumulation state (a resumable representation — the
    checkpoint/resume unit, SURVEY §5)."""
    rgb_sum: jnp.ndarray      # (H, W, 3) sensor-RGB weighted sums
    weight_sum: jnp.ndarray   # (H, W)
    spp_done: jnp.ndarray     # scalar int32 — progressive sample counter

    def tree_flatten(self):
        return (self.rgb_sum, self.weight_sum, self.spp_done), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def create(cls, resolution):
        w, h = resolution
        return cls(jnp.zeros((h, w, 3), jnp.float32),
                   jnp.zeros((h, w), jnp.float32),
                   jnp.zeros((), jnp.int32))

    def add_aligned(self, rgb, weight, spp_added=1):
        """Accumulate a full (H, W, [spp,] 3) sample pass where samples are
        already organized per pixel (the wavefront fast path — no scatter)."""
        if rgb.ndim == 4:  # (H, W, spp, 3)
            rgb_add = jnp.sum(rgb * weight[..., None], axis=2)
            w_add = jnp.sum(weight, axis=2)
        else:
            rgb_add = rgb * weight[..., None]
            w_add = weight
        return Film(self.rgb_sum + rgb_add, self.weight_sum + w_add,
                    self.spp_done + spp_added)

    def add_scattered(self, pixel_idx, rgb, weight, spp_added=0):
        """Scatter-add arbitrary samples by linear pixel index (the
        segment-sum splatting path for filter-importance offsets that cross
        pixel boundaries, or for compacted ray batches)."""
        h, w = self.weight_sum.shape
        flat_rgb = self.rgb_sum.reshape(h * w, 3)
        flat_w = self.weight_sum.reshape(h * w)
        flat_rgb = flat_rgb.at[pixel_idx].add(rgb * weight[..., None])
        flat_w = flat_w.at[pixel_idx].add(weight)
        return Film(flat_rgb.reshape(h, w, 3), flat_w.reshape(h, w),
                    self.spp_done + spp_added)

    def resolve(self, sensor: sen.PixelSensor, colorspace=None,
                exposure=1.0, to_srgb=True, clip=True):
        """rgbsum/weightsum → XYZ → output RGB (→ sRGB encode), matching
        RayTracerTestApp.h:437-445. `clip=False` returns unbounded linear
        RGB for quantitative comparisons."""
        cs = colorspace or colorlib.SRGB
        w = jnp.maximum(self.weight_sum[..., None], 1e-12)
        sensor_rgb = self.rgb_sum / w * exposure
        xyz = sensor.sensor_rgb_to_xyz(sensor_rgb)
        rgb = cs.to_rgb(xyz)
        if clip:
            rgb = jnp.clip(rgb, 0.0, 1.0)
        if to_srgb:
            rgb = colorlib.linear_to_srgb(rgb)
        return rgb

    def merge(self, other):
        """Associative merge of independently accumulated films (the
        multi-chip reduction)."""
        return Film(self.rgb_sum + other.rgb_sum,
                    self.weight_sum + other.weight_sum,
                    self.spp_done + other.spp_done)
