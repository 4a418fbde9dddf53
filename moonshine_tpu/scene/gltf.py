"""Binary glTF (.glb) ingest.

Replaces the reference's zgltf + zigimg pipeline and reproduces the
conversion rules of World.fromGlb (World.zig:233-363), gltfMaterialToMaterial
(World.zig:44-228), and Camera.Lens.fromGlb (Camera.zig:26-52):

  * transmission_factor == 1  -> Glass(ior)
  * metallic-roughness texture -> StandardPBR (r = metalness, g = roughness,
    linear); else constants, with metallic==0 && roughness==1 -> Lambert and
    metallic==1 && roughness==0 -> PerfectMirror
  * base color / emissive textures are sRGB-decoded to linear (the reference
    samples them through *_srgb formats); normal/metal-rough stay linear
  * constant emissive = emissive_factor * KHR emissive_strength
  * a material named "Emitter*" marks its geometry as NEE-sampled
  * Y-up glTF -> Z-up world: permute global-transform rows (0, 2, 1)
  * camera = first camera node; origin/forward/up from its Z-up transform

PNG decode goes through io/png.py instead of zigimg; the parser itself is
self-contained (GLB container, accessors, node hierarchy).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from ..io import png
from .types import (
    Geometry,
    Glass,
    Instance,
    Lambert,
    Lens,
    MaterialInfo,
    Mesh,
    Mirror,
    StandardPBR,
)
from .world import World

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


@dataclass
class Glb:
    json: dict
    binary: bytes
    # directory for resolving external buffer/image uris (.gltf files);
    # None = GLB with everything embedded
    base_dir: "str | None" = None

    @staticmethod
    def load(path) -> "Glb":
        """Read a .glb (binary container) or .gltf (JSON + external .bin
        buffers/images, zgltf's other supported container)."""
        import os

        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            return Glb.parse(data)
        doc = json.loads(data)
        base_dir = os.path.dirname(os.fspath(path))
        binary = b""
        buffers = doc.get("buffers", [])
        if buffers:
            uri = buffers[0].get("uri")
            if uri is not None:
                binary = _read_uri(uri, base_dir)
        return Glb(json=doc, binary=binary, base_dir=base_dir)

    @staticmethod
    def parse(data: bytes) -> "Glb":
        magic, version, _length = struct.unpack_from("<4sII", data, 0)
        if magic != b"glTF":
            raise ValueError("not a GLB file")
        if version != 2:
            raise ValueError(f"unsupported GLB version {version}")
        off = 12
        doc, binary = None, b""
        while off < len(data):
            clen, ctype = struct.unpack_from("<I4s", data, off)
            off += 8
            chunk = data[off : off + clen]
            off += clen
            if ctype == b"JSON":
                doc = json.loads(chunk)
            elif ctype == b"BIN\x00":
                binary = chunk
        if doc is None:
            raise ValueError("GLB missing JSON chunk")
        return Glb(json=doc, binary=binary)

    def accessor(self, index: int) -> np.ndarray:
        acc = self.json["accessors"][index]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        count = acc["count"]
        if "bufferView" not in acc:
            return np.zeros((count, n_comp), dtype)
        bv = self.json["bufferViews"][acc["bufferView"]]
        base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0)
        item = np.dtype(dtype).itemsize * n_comp
        if stride and stride != item:
            rows = [
                np.frombuffer(self.binary, dtype, n_comp, base + i * stride)
                for i in range(count)
            ]
            out = np.stack(rows)
        else:
            out = np.frombuffer(self.binary, dtype, count * n_comp, base)
            out = out.reshape(count, n_comp)
        out = out.copy()
        if "sparse" in acc:
            out = self._apply_sparse(acc, out)
        return out

    def _apply_sparse(self, acc: dict, out: np.ndarray) -> np.ndarray:
        """Sparse accessor overlay (glTF 2.0 §3.6.2.3): substitute
        `count` rows at `indices` with `values`."""
        sp = acc["sparse"]
        n = sp["count"]
        n_comp = out.shape[1]

        def block(ref, dtype, comps):
            bv = self.json["bufferViews"][ref["bufferView"]]
            base = bv.get("byteOffset", 0) + ref.get("byteOffset", 0)
            return np.frombuffer(self.binary, dtype, n * comps, base)

        idx = block(sp["indices"],
                    _COMPONENT_DTYPES[sp["indices"]["componentType"]], 1)
        vals = block(sp["values"], out.dtype, n_comp).reshape(n, n_comp)
        out[idx.astype(np.int64)] = vals
        return out

    def image_rgba(self, image_index: int) -> np.ndarray:
        """Decode an embedded image to float [h,w,4] in [0,1] (no transfer
        function applied)."""
        img_def = self.json["images"][image_index]
        if "bufferView" in img_def:
            bv = self.json["bufferViews"][img_def["bufferView"]]
            base = bv.get("byteOffset", 0)
            raw = self.binary[base : base + bv["byteLength"]]
        elif "uri" in img_def:
            raw = _read_uri(img_def["uri"], self.base_dir)
        else:
            raise ValueError("glTF image has neither bufferView nor uri")
        return png.decode(raw)

    def texture_image(self, texture_index: int) -> np.ndarray:
        tex = self.json["textures"][texture_index]
        return self.image_rgba(tex["source"])


def _read_uri(uri: str, base_dir) -> bytes:
    """data: URIs and sibling files (the two uri kinds glTF allows)."""
    if uri.startswith("data:"):
        import base64

        return base64.b64decode(uri.split(",", 1)[1])
    import os
    import urllib.parse

    rel = urllib.parse.unquote(uri)
    path = os.path.join(base_dir or ".", rel)
    with open(path, "rb") as f:
        return f.read()


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode (the reference's *_srgb sampling)."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def _node_transforms(doc: dict) -> list[np.ndarray]:
    """Global 4x4 transforms for every node (zgltf getGlobalTransform)."""
    nodes = doc.get("nodes", [])
    parents = {}
    for i, node in enumerate(nodes):
        for c in node.get("children", []):
            parents[c] = i

    def local(node):
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in node:
            m = m @ np.diag(np.asarray(list(node["scale"]) + [1.0], np.float32))
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.asarray(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ],
                np.float32,
            )
            rm = np.eye(4, dtype=np.float32)
            rm[:3, :3] = r
            m = rm @ m
        if "translation" in node:
            tm = np.eye(4, dtype=np.float32)
            tm[:3, 3] = node["translation"]
            m = tm @ m
        return m

    out = [None] * len(nodes)

    def global_of(i):
        if out[i] is None:
            g = local(nodes[i])
            if i in parents:
                g = global_of(parents[i]) @ g
            out[i] = g
        return out[i]

    for i in range(len(nodes)):
        global_of(i)
    return out


def _zup(mat4: np.ndarray) -> np.ndarray:
    """Y-up 4x4 -> Z-up 3x4 by taking rows (0, 2, 1) (World.zig:341-347)."""
    return mat4[[0, 2, 1], :4].astype(np.float32)


def _convert_material(glb: Glb, mat_def: dict,
                      spec_channels: bool = True) -> MaterialInfo:
    pbr = mat_def.get("pbrMetallicRoughness", {})
    ext = mat_def.get("extensions", {})
    ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)

    if "normalTexture" in mat_def:
        img = glb.texture_image(mat_def["normalTexture"]["index"])
        normal = img[..., :2]  # rg, linear (World.zig:50-75)
    else:
        normal = None

    if "emissiveTexture" in mat_def:
        emissive = srgb_to_linear(
            glb.texture_image(mat_def["emissiveTexture"]["index"])[..., :3]
        )
    else:
        strength = ext.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0
        )
        emissive = tuple(
            np.asarray(mat_def.get("emissiveFactor", [0, 0, 0]), np.float32)
            * strength
        )

    transmission = ext.get("KHR_materials_transmission", {}).get(
        "transmissionFactor", 0.0
    )
    if transmission == 1.0:
        return MaterialInfo(variant=Glass(ior=ior), normal=normal, emissive=emissive)

    if "baseColorTexture" in pbr:
        color = srgb_to_linear(
            glb.texture_image(pbr["baseColorTexture"]["index"])[..., :3]
        )
    else:
        color = tuple(
            np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)[:3]
        )

    metallic = pbr.get("metallicFactor", 1.0)
    roughness = pbr.get("roughnessFactor", 1.0)

    if "metallicRoughnessTexture" in pbr:
        img = glb.texture_image(pbr["metallicRoughnessTexture"]["index"])
        # glTF spec: blue = metallic, green = roughness. The reference reads
        # metallic from red (World.zig:173-175), a spec deviation; pass
        # spec_channels=False (e.g. via world_from_glb) to mirror it when
        # comparing images against reference renders of such assets.
        metal_ch = 2 if spec_channels else 0
        variant = StandardPBR(
            color=color,
            metalness=img[..., metal_ch : metal_ch + 1],
            roughness=img[..., 1:2],
            ior=ior,
        )
    elif metallic == 0.0 and roughness == 1.0:
        variant = Lambert(color=color)
    elif metallic == 1.0 and roughness == 0.0:
        variant = Mirror()
    else:
        variant = StandardPBR(
            color=color, metalness=metallic, roughness=roughness, ior=ior
        )
    return MaterialInfo(variant=variant, normal=normal, emissive=emissive)


def world_from_glb(path_or_bytes, world: World | None = None,
                   spec_channels: bool = True) -> World:
    """Populate a World from a .glb or .gltf (World.fromGlb parity)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        glb = Glb.parse(bytes(path_or_bytes))
    else:
        glb = Glb.load(path_or_bytes)
    doc = glb.json
    if world is None:
        world = World()

    materials = doc.get("materials", [])
    mat_handles = [
        world.add_material(_convert_material(glb, m, spec_channels))
        for m in materials
    ]
    if not mat_handles:
        mat_handles = [world.add_material(MaterialInfo(variant=Lambert()))]

    transforms = _node_transforms(doc)
    for node_idx, node in enumerate(doc.get("nodes", [])):
        if "mesh" not in node:
            continue
        mesh_def = doc["meshes"][node["mesh"]]
        geometries = []
        for prim in mesh_def.get("primitives", []):
            attrs = prim["attributes"]
            positions = glb.accessor(attrs["POSITION"]).astype(np.float32)
            normals = (
                glb.accessor(attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else None
            )
            texcoords = (
                glb.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            if "indices" in prim:
                indices = glb.accessor(prim["indices"]).reshape(-1, 3)
            else:
                indices = np.arange(len(positions), dtype=np.uint32).reshape(-1, 3)
            mesh_handle = world.add_mesh(
                Mesh(
                    positions=positions,
                    indices=indices.astype(np.uint32),
                    normals=normals,
                    texcoords=texcoords,
                )
            )
            mat_idx = prim.get("material", 0)
            name = materials[mat_idx].get("name", "") if materials else ""
            geometries.append(
                Geometry(
                    mesh=mesh_handle,
                    material=mat_handles[mat_idx] if materials else mat_handles[0],
                    sampled=name.startswith("Emitter"),  # World.zig:271
                )
            )
        world.add_instance(
            Instance(transform=_zup(transforms[node_idx]), geometries=geometries)
        )
    return world


def lens_from_glb(path_or_bytes) -> Lens:
    """First camera node -> Lens (Camera.zig:26-52)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        glb = Glb.parse(bytes(path_or_bytes))
    else:
        glb = Glb.load(path_or_bytes)
    doc = glb.json
    transforms = _node_transforms(doc)
    for node_idx, node in enumerate(doc.get("nodes", [])):
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            t = _zup(transforms[node_idx])
            lin = t[:, :3]
            origin = t[:, 3]
            forward = lin @ np.asarray([0, 0, -1], np.float32)
            forward /= np.linalg.norm(forward)
            up = lin @ np.asarray([0, 1, 0], np.float32)
            return Lens(
                origin=origin.astype(np.float32),
                forward=forward.astype(np.float32),
                up=up.astype(np.float32),
                vfov=float(cam["perspective"]["yfov"]),
                aperture=0.0,
                focus_distance=1.0,
            )
    raise ValueError("no camera in glb")  # error.NoCameraInGlb
