"""The golden-image render configs (BASELINE.md row 3) and their renderer,
shared by tests/test_golden.py and the GPU-vs-CPU golden gate in bench.py
and chip_smoke.py. Imports nothing beyond JAX, NumPy and the package."""

import os

import numpy as np
import jax.numpy as jnp

from computational_ray_tracer_tpu.models.scene import Scene
from computational_ray_tracer_tpu.models import integrator as integ
from computational_ray_tracer_tpu.ops import camera as cam
from computational_ray_tracer_tpu.ops import shapes as shp
from computational_ray_tracer_tpu.ops import triangle as trimod
from computational_ray_tracer_tpu.utils import mesh_gen

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def golden1_sphere_direct():
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.6, 0.3, 0.25)}],
        lights=[{"kind": "point", "position": (3.0, 4.0, -3.0),
                 "rgb": (1.0, 1.0, 1.0), "scale": 50.0}],
        spheres=[{"radius": 1.0, "transform": shp.make_transform((0, 0, 0)),
                  "material": 0}])
    camera = cam.PerspectiveCamera.create((0, 0, -4), (32, 32), fov_y=40.0,
                                          look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="stratified", spp=4, xs=2, ys=2),
        integrator="direct", max_depth=1)
    return scene, camera, cfg


def golden2_cornell_path(res=32, spp=4):
    pos, idx, uv, mats, (lc, le1, le2) = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.73, 0.73, 0.73)},
                   {"kind": "diffuse", "albedo_rgb": (0.65, 0.05, 0.05)},
                   {"kind": "diffuse", "albedo_rgb": (0.12, 0.45, 0.15)},
                   {"kind": "diffuse", "albedo_rgb": (0, 0, 0),
                    "emission_rgb": (1.0, 0.85, 0.6), "emission_scale": 6.0}],
        lights=[{"kind": "quad", "corner": tuple(lc), "edge1": tuple(le1),
                 "edge2": tuple(le2), "rgb": (1.0, 0.85, 0.6), "scale": 6.0}],
        mesh=(mesh, jnp.asarray(mats)), use_octree=False)
    camera = cam.PerspectiveCamera.create((0, 0, -2.8), (res, res),
                                          fov_y=50.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=4)
    return scene, camera, cfg


def golden3_mesh_octree_textured(res=32, spp=2):
    out = mesh_gen.uv_sphere((0.0, 0.0, 0.0), 1.0, n_theta=24, n_phi=24)
    mesh = trimod.MeshData.build(out[0], out[1], uvs=out[2])
    tex = mesh_gen.checker_texture(32)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (1.0, 1.0, 1.0),
                    "use_texture": True}],
        lights=[{"kind": "distant", "direction": (-0.3, -1.0, 0.4),
                 "rgb": (1.0, 1.0, 1.0), "scale": 40.0}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, texture_rgb=tex)
    camera = cam.PerspectiveCamera.create((0, 0.6, -3.2), (res, res),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="independent", spp=spp),
        integrator="direct", max_depth=1)
    return scene, camera, cfg


def golden4_spectral():
    from computational_ray_tracer_tpu.ops import spectrum as spec
    from computational_ray_tracer_tpu.ops import spectra_data as data
    bb = np.asarray(spec.BlackbodySpectrum(2856.0)(
        jnp.asarray(data.DENSE_LAMBDA, jnp.float32))) * 100.0
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.7, 0.7)},
                   {"kind": "conductor", "albedo_rgb": (1, 1, 1),
                    "metal": "metal-Au"},
                   {"kind": "dielectric", "albedo_rgb": (1, 1, 1),
                    "eta": 1.5}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "spd_dense": bb, "scale": 0.5}],
        spheres=[{"radius": 0.8, "transform": shp.make_transform((-1.8, 0, 0)),
                  "material": 0},
                 {"radius": 0.8, "transform": shp.make_transform((0, 0, 0)),
                  "material": 1},
                 {"radius": 0.8, "transform": shp.make_transform((1.8, 0, 0)),
                  "material": 2}])
    camera = cam.PerspectiveCamera.create((0, 0.8, -4.5), (32, 32),
                                          fov_y=45.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="sobol", spp=4),
        integrator="path", max_depth=4)
    return scene, camera, cfg


GOLDENS = {
    "config1_sphere_direct": golden1_sphere_direct,
    "config2_cornell_path": golden2_cornell_path,
    "config3_mesh_octree_textured": golden3_mesh_octree_textured,
    "config4_spectral": golden4_spectral,
    # Higher-resolution variants: at 32x32, structure
    # below ~3% of image extent is invisible — 128x128 catches silhouette /
    # filter regressions. config2_128 doubles as the GPU-vs-CPU-golden gate
    # rendered by bench.py and chip_smoke.py on the card (BASELINE.md row 3).
    "config2_cornell_path_128": lambda: golden2_cornell_path(res=128, spp=4),
    "config3_mesh_octree_textured_128":
        lambda: golden3_mesh_octree_textured(res=128, spp=2),
}


def _render(builder):
    scene, camera, cfg = builder()
    film, sensor = integ.render(scene, camera, cfg, chunk=cfg.sampler.spp)
    return np.asarray(film.resolve(sensor, to_srgb=False, clip=False))
