"""Multi-format asset import: OBJ+MTL material binding and PLY meshes
(reference: ASSIMPLoader::Load multi-format path with per-submesh material
indices, RayTracer/AssetManager.cpp:67-191)."""

import textwrap

import numpy as np
import pytest

from computational_ray_tracer_tpu.utils import obj_loader, ply_loader

MTL = textwrap.dedent("""\
    # two-material library
    newmtl red_wall
    Kd 0.8 0.1 0.1
    Ks 0.0 0.0 0.0
    Ns 10
    illum 2

    newmtl lamp
    Kd 0.0 0.0 0.0
    Ke 4.0 3.5 3.0

    newmtl glass
    Kd 1 1 1
    Ni 1.52
    d 0.1
    illum 7

    newmtl brushed
    Kd 0.05 0.05 0.05
    Ks 0.9 0.9 0.9
    Ns 200
    """)

OBJ = textwrap.dedent("""\
    mtllib scene.mtl
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    v 1 0 1
    usemtl red_wall
    f 1 2 3 4
    usemtl lamp
    f 1 2 5
    usemtl glass
    f 2 6 5
    usemtl brushed
    f 1 5 4
    """)


@pytest.fixture()
def obj_path(tmp_path):
    (tmp_path / "scene.mtl").write_text(MTL)
    p = tmp_path / "scene.obj"
    p.write_text(OBJ)
    return p


class TestMTL:
    def test_material_kinds(self, obj_path):
        mats = obj_loader.load_mtl(obj_path.parent / "scene.mtl")
        assert mats["red_wall"]["kind"] == "diffuse"
        assert mats["red_wall"]["albedo_rgb"] == (0.8, 0.1, 0.1)
        assert mats["lamp"]["emission_rgb"] == (4.0, 3.5, 3.0)
        assert mats["glass"]["kind"] == "dielectric"
        assert mats["glass"]["eta"] == 1.52
        assert mats["brushed"]["kind"] == "rough_conductor"
        # Blinn-Phong Ns=200 -> alpha = sqrt(2/202) ~ 0.0995
        assert abs(mats["brushed"]["roughness"] - (2.0 / 202.0) ** 0.5) < 1e-6

    def test_obj_scene_binding(self, obj_path):
        pos, idx, nrm, uv, tri_mat, mats = obj_loader.load_obj_scene(obj_path)
        # quad -> 2 tris (mat 0), then one tri each of mats 1, 2, 3
        assert idx.shape == (5, 3)
        np.testing.assert_array_equal(tri_mat, [0, 0, 1, 2, 3])
        assert [m["kind"] for m in mats] == [
            "diffuse", "diffuse", "dielectric", "rough_conductor"]
        assert mats[1]["emission_rgb"] == (4.0, 3.5, 3.0)

    def test_default_material_when_no_usemtl(self, tmp_path):
        p = tmp_path / "plain.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        pos, idx, nrm, uv, tri_mat, mats = obj_loader.load_obj_scene(p)
        np.testing.assert_array_equal(tri_mat, [0])
        assert mats[0]["kind"] == "diffuse"

    def test_geometry_matches_plain_loader(self, obj_path):
        pos, idx, nrm, uv, tri_mat, mats = obj_loader.load_obj_scene(obj_path)
        pos2, idx2, nrm2, uv2 = obj_loader.load_obj(obj_path, native=False)
        np.testing.assert_allclose(pos, pos2)
        np.testing.assert_array_equal(idx, idx2)

    def test_renders_multi_material_obj(self, obj_path):
        """End-to-end: textured multi-material OBJ through Scene + direct
        integrator."""
        import jax.numpy as jnp
        from computational_ray_tracer_tpu.models.scene import Scene
        from computational_ray_tracer_tpu.models import integrator as integ
        from computational_ray_tracer_tpu.ops import camera as cam
        from computational_ray_tracer_tpu.ops import triangle as trimod

        pos, idx, nrm, uv, tri_mat, mats = obj_loader.load_obj_scene(obj_path)
        mesh = trimod.MeshData.build(pos, idx, normals=nrm, uvs=uv)
        scene = Scene.build(
            materials=mats,
            lights=[{"kind": "distant", "direction": (0, 0, -1),
                     "rgb": (1, 1, 1), "scale": 3.0}],
            mesh=(mesh, jnp.asarray(tri_mat)),
            use_octree=False)
        camera = cam.PerspectiveCamera.create((0.5, 0.5, 3.0), (16, 16),
                                              fov_y=45.0,
                                              look_at=(0.5, 0.5, 0.0))
        cfg = integ.RenderConfig(resolution=(16, 16),
                                 sampler=integ.SamplerConfig(kind="independent",
                                                             spp=4),
                                 integrator="direct", max_depth=1)
        film, sensor = integ.render(scene, camera, cfg)
        img = np.asarray(film.resolve(sensor))
        assert np.all(np.isfinite(img))
        assert img.max() > 0.01  # something is lit


class TestPLY:
    def _mesh(self):
        pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0.5, 0.5, 1]], np.float32)
        idx = np.array([[0, 1, 2], [0, 2, 3], [0, 1, 4]], np.int32)
        nrm = np.tile(np.array([[0, 0, 1]], np.float32), (5, 1))
        uv = pos[:, :2].copy()
        return pos, idx, nrm, uv

    @pytest.mark.parametrize("binary", [False, True])
    def test_roundtrip(self, tmp_path, binary):
        pos, idx, nrm, uv = self._mesh()
        p = tmp_path / "m.ply"
        ply_loader.save_ply(p, pos, idx, normals=nrm, uvs=uv, binary=binary)
        pos2, idx2, nrm2, uv2 = ply_loader.load_ply(p)
        np.testing.assert_allclose(pos2, pos, rtol=1e-6)
        np.testing.assert_array_equal(idx2, idx)
        np.testing.assert_allclose(nrm2, nrm)
        np.testing.assert_allclose(uv2, uv, rtol=1e-6)

    def test_positions_only(self, tmp_path):
        pos, idx, _, _ = self._mesh()
        p = tmp_path / "m.ply"
        ply_loader.save_ply(p, pos, idx, binary=True)
        pos2, idx2, nrm2, uv2 = ply_loader.load_ply(p)
        np.testing.assert_allclose(pos2, pos)
        assert nrm2 is None and uv2 is None

    def test_quad_fan_triangulation(self, tmp_path):
        p = tmp_path / "quad.ply"
        p.write_text(textwrap.dedent("""\
            ply
            format ascii 1.0
            element vertex 4
            property float x
            property float y
            property float z
            element face 1
            property list uchar int vertex_indices
            end_header
            0 0 0
            1 0 0
            1 1 0
            0 1 0
            4 0 1 2 3
            """))
        pos, idx, nrm, uv = ply_loader.load_ply(p)
        np.testing.assert_array_equal(idx, [[0, 1, 2], [0, 2, 3]])

    def test_big_endian(self, tmp_path):
        pos, idx, _, _ = self._mesh()
        p = tmp_path / "be.ply"
        header = ("ply\nformat binary_big_endian 1.0\n"
                  f"element vertex {len(pos)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  f"element face {len(idx)}\n"
                  "property list uchar int vertex_indices\nend_header\n")
        with open(p, "wb") as f:
            f.write(header.encode())
            f.write(np.ascontiguousarray(pos, ">f4").tobytes())
            face = np.empty((len(idx),),
                            np.dtype([("n", "u1"), ("v", ">i4", (3,))]))
            face["n"] = 3
            face["v"] = idx
            f.write(face.tobytes())
        pos2, idx2, _, _ = ply_loader.load_ply(p)
        np.testing.assert_allclose(pos2, pos)
        np.testing.assert_array_equal(idx2, idx)

    def test_mesh_cache_ply(self, tmp_path):
        pos, idx, nrm, uv = self._mesh()
        p = tmp_path / "cached.ply"
        ply_loader.save_ply(p, pos, idx, normals=nrm, uvs=uv)
        obj_loader.MeshCache.clear()
        mesh = obj_loader.MeshCache.load("cached", p)
        assert int(mesh.n_triangles) == 3
        assert obj_loader.MeshCache.load("cached", p) is mesh
