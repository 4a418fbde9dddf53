"""GLB ingest: parser, material classification, Z-up conversion, camera,
and a Cornell-box render through the offline CLI."""

import numpy as np
import pytest

from moonshine_tpu.io import png
from moonshine_tpu.scene import gltf
from moonshine_tpu.scene.types import Glass, Lambert, Mirror, StandardPBR
from moonshine_tpu.scene.world import TYPE_LAMBERT

from glb_builder import build_glb, cornell_box_glb, quad


def png_bytes(rgb, size=(2, 2)):
    px = np.asarray([int(c * 255) for c in rgb], np.uint8)
    return png.encode(np.broadcast_to(px, (size[1], size[0], 3)))


class TestParser:
    def test_mesh_and_transform_zup(self):
        positions, indices = quad()
        glb = build_glb(
            meshes=[{"positions": positions, "indices": indices}],
            materials=[{"name": "m", "pbrMetallicRoughness": {
                "metallicFactor": 0.0, "roughnessFactor": 1.0}}],
            nodes=[{"mesh": 0, "translation": [1.0, 2.0, 3.0]}],
        )
        world = gltf.world_from_glb(glb)
        assert len(world.meshes) == 1
        assert len(world.instances) == 1
        # glTF translation (1,2,3) Y-up -> Z-up world (1,3,2)
        np.testing.assert_allclose(
            world.instances[0].transform[:, 3], [1.0, 3.0, 2.0]
        )
        np.testing.assert_array_equal(
            world.meshes[0].positions, positions
        )

    def test_material_classification(self):
        positions, indices = quad()
        materials = [
            {"name": "lam", "pbrMetallicRoughness": {
                "metallicFactor": 0.0, "roughnessFactor": 1.0,
                "baseColorFactor": [0.5, 0.25, 0.125, 1.0]}},
            {"name": "mirror", "pbrMetallicRoughness": {
                "metallicFactor": 1.0, "roughnessFactor": 0.0}},
            {"name": "glass", "pbrMetallicRoughness": {},
             "extensions": {
                 "KHR_materials_transmission": {"transmissionFactor": 1.0},
                 "KHR_materials_ior": {"ior": 1.45}}},
            {"name": "pbr", "pbrMetallicRoughness": {
                "metallicFactor": 0.5, "roughnessFactor": 0.5}},
            {"name": "Emitter_light", "pbrMetallicRoughness": {
                "metallicFactor": 0.0, "roughnessFactor": 1.0},
             "emissiveFactor": [1, 1, 1],
             "extensions": {"KHR_materials_emissive_strength": {
                 "emissiveStrength": 5.0}}},
        ]
        meshes = [
            {"positions": positions, "indices": indices, "material": i}
            for i in range(5)
        ]
        nodes = [{"mesh": i} for i in range(5)]
        world = gltf.world_from_glb(build_glb(meshes, materials, nodes))

        v0 = world.materials[0].variant
        assert isinstance(v0, Lambert)
        np.testing.assert_allclose(v0.color, [0.5, 0.25, 0.125])
        assert isinstance(world.materials[1].variant, Mirror)
        v2 = world.materials[2].variant
        assert isinstance(v2, Glass) and v2.ior == pytest.approx(1.45)
        v3 = world.materials[3].variant
        assert isinstance(v3, StandardPBR)
        assert v3.metalness == 0.5 and v3.roughness == 0.5
        # default metallic=1 roughness=1 -> StandardPBR (not lambert/mirror)
        assert isinstance(v2, Glass)
        # Emitter prefix marks geometry sampled; emissive scaled by strength
        np.testing.assert_allclose(world.materials[4].emissive, [5.0, 5.0, 5.0])
        assert world.instances[4].geometries[0].sampled
        assert not world.instances[0].geometries[0].sampled

    def test_textured_material(self):
        positions, indices = quad()
        uv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
        glb = build_glb(
            meshes=[{"positions": positions, "indices": indices,
                     "texcoords": uv}],
            materials=[{"name": "t", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0, "roughnessFactor": 1.0}}],
            nodes=[{"mesh": 0}],
            images=[png_bytes((0.5, 0.2, 0.1))],
        )
        world = gltf.world_from_glb(glb)
        v = world.materials[0].variant
        assert isinstance(v, (Lambert, StandardPBR))
        img = np.asarray(v.color)
        assert img.ndim == 3
        # sRGB 0.5 decodes to ~0.214 linear
        assert abs(img[0, 0, 0] - 0.2140) < 2e-2

    def test_metallic_roughness_channels(self):
        """spec_channels=True reads metallic from blue (glTF spec);
        spec_channels=False mirrors the reference's red-channel read
        (World.zig:173-175) for image-parity comparisons."""
        positions, indices = quad()
        uv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])

        def load(spec_channels):
            glb = build_glb(
                meshes=[{"positions": positions, "indices": indices,
                         "texcoords": uv}],
                materials=[{"name": "mr", "pbrMetallicRoughness": {
                    "metallicRoughnessTexture": {"index": 0}}}],
                nodes=[{"mesh": 0}],
                images=[png_bytes((1.0, 0.5, 0.0))],  # r=1, g=0.5, b=0
            )
            return gltf.world_from_glb(
                glb, spec_channels=spec_channels
            ).materials[0].variant

        v_spec = load(True)
        v_ref = load(False)
        assert isinstance(v_spec, StandardPBR)
        assert np.asarray(v_spec.metalness).max() == 0.0   # blue channel
        assert np.asarray(v_ref.metalness).min() == 1.0    # red channel
        np.testing.assert_allclose(
            np.asarray(v_spec.roughness), np.asarray(v_ref.roughness)
        )

    def test_camera(self):
        positions, indices = quad()
        glb = build_glb(
            meshes=[{"positions": positions, "indices": indices}],
            materials=[{"name": "m"}],
            nodes=[{"mesh": 0},
                   {"camera": 0, "translation": [0.0, 1.0, 5.0]}],
            cameras=[{"type": "perspective",
                      "perspective": {"yfov": 0.7, "znear": 0.01}}],
        )
        lens = gltf.lens_from_glb(glb)
        # Y-up (0,1,5) -> Z-up (0,5,1); looking down glTF -Z -> world -Y
        np.testing.assert_allclose(lens.origin, [0, 5, 1], atol=1e-6)
        np.testing.assert_allclose(lens.forward, [0, -1, 0], atol=1e-6)
        np.testing.assert_allclose(lens.up, [0, 0, 1], atol=1e-6)
        assert lens.vfov == pytest.approx(0.7)

    def test_device_scene_builds(self):
        world = gltf.world_from_glb(cornell_box_glb())
        scene = world.build()
        assert scene.num_tris == 12
        assert int(scene.emitters.count) == 2
        assert int(scene.materials.packed[0, 0]) == TYPE_LAMBERT


class TestOfflineCli:
    def test_cornell_render_end_to_end(self, tmp_path):
        from moonshine_tpu.io.exr import read_exr, write_exr
        from moonshine_tpu.render import offline

        glb_path = tmp_path / "cornell.glb"
        glb_path.write_bytes(cornell_box_glb())
        sky = np.zeros((8, 16, 3), np.float32)  # black sky: interior scene
        sky_path = tmp_path / "sky.exr"
        write_exr(sky_path, sky)
        out_path = tmp_path / "out.exr"

        rc = offline.main([
            str(glb_path), str(sky_path), str(out_path),
            "--spp", "12", "--width", "40", "--height", "30",
            "--max-bounces", "4",
        ])
        assert rc == 0
        img = read_exr(out_path)[..., :3]
        assert img.shape == (30, 40, 3)
        assert not np.isnan(img).any()
        assert img.mean() > 0.02, "cornell box should not be black"
        # camera looks down world -Y, so camera-right = -X: the red wall
        # (x=-1) lands on the image's right, green (x=+1) on the left
        left = img[10:20, :8].mean(axis=(0, 1))
        right = img[10:20, -8:].mean(axis=(0, 1))
        assert left[1] > left[0], f"left wall should be green-ish {left}"
        assert right[0] > right[1], f"right wall should be red-ish {right}"


if __name__ == "__main__":
    pytest.main([__file__, "-q", "-x"])

class TestContainersAndSparse:
    def test_sparse_accessor_overlay(self):
        """glTF 2.0 sparse accessors: base rows + index/value substitution."""
        from moonshine_tpu.scene.gltf import Glb

        base = np.arange(12, dtype=np.float32).reshape(4, 3)
        idx = np.asarray([1, 3], np.uint16)
        vals = np.asarray([[9, 9, 9], [7, 7, 7]], np.float32)
        binary = base.tobytes() + idx.tobytes() + vals.tobytes()
        doc = {
            "bufferViews": [
                {"buffer": 0, "byteOffset": 0, "byteLength": base.nbytes},
                {"buffer": 0, "byteOffset": base.nbytes,
                 "byteLength": idx.nbytes},
                {"buffer": 0, "byteOffset": base.nbytes + idx.nbytes,
                 "byteLength": vals.nbytes},
            ],
            "accessors": [{
                "bufferView": 0, "componentType": 5126, "count": 4,
                "type": "VEC3",
                "sparse": {
                    "count": 2,
                    "indices": {"bufferView": 1, "componentType": 5123},
                    "values": {"bufferView": 2},
                },
            }],
        }
        out = Glb(json=doc, binary=binary).accessor(0)
        want = base.copy()
        want[[1, 3]] = vals
        np.testing.assert_array_equal(out, want)

    def test_gltf_json_container_with_external_bin(self, tmp_path):
        """.gltf + sibling .bin loads identically to the .glb container."""
        import json as _json
        import struct

        from moonshine_tpu.scene import gltf

        glb_bytes = cornell_box_glb()
        parsed = gltf.Glb.parse(glb_bytes)
        doc = dict(parsed.json)
        doc["buffers"] = [{"uri": "scene.bin",
                           "byteLength": len(parsed.binary)}]
        (tmp_path / "scene.bin").write_bytes(parsed.binary)
        (tmp_path / "scene.gltf").write_text(_json.dumps(doc))

        w_glb = gltf.world_from_glb(glb_bytes)
        w_gltf = gltf.world_from_glb(tmp_path / "scene.gltf")
        assert len(w_gltf.meshes) == len(w_glb.meshes)
        for a, b in zip(w_gltf.meshes, w_glb.meshes):
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.indices, b.indices)

    def test_gltf_data_uri_buffer(self, tmp_path):
        """Buffers inlined as base64 data: URIs."""
        import base64
        import json as _json

        from moonshine_tpu.scene import gltf

        parsed = gltf.Glb.parse(cornell_box_glb())
        doc = dict(parsed.json)
        uri = "data:application/octet-stream;base64," + base64.b64encode(
            parsed.binary).decode()
        doc["buffers"] = [{"uri": uri, "byteLength": len(parsed.binary)}]
        (tmp_path / "inline.gltf").write_text(_json.dumps(doc))
        w = gltf.world_from_glb(tmp_path / "inline.gltf")
        assert len(w.meshes) > 0
