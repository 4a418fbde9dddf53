"""Material texture storage: two independently-sized blocks per material.

The reference binds up to 1024 independently-sized images through a
bindless descriptor array and samples five of them per hit (color,
metalness, roughness, emissive, normal — material.hlsl loads + getEmissive
+ getTextureFrame). Five separate bilinear lookups would be ~25 gathers per
bounce, so maps are packed channel-wise into block images fetched with one
bilinear gather each. Two blocks per material, sized
independently so a big base-color map doesn't force big storage for maps
that are constants:

  block A (BSDF maps, usually authored at one resolution together):
      channels 0-2 color | 3 metalness | 4 roughness | 5-6 normal (rg) | 7 pad
  block B (emissive, usually 1x1 black):
      channels 0-2 emissive | 3-7 pad

Differently-sized maps inside one block are bilinear-upsampled to the
largest (a build-time prefilter the reference's per-image samplers don't
need). Storage is bfloat16 — >= the 8-bit precision of typical PNG
sources — so a 2048^2 fully-textured PBR material costs
2048^2 * 8ch * 2B = 64 MB instead of the 256 MB a single 16-channel f32
block did (the reference's native-size RGBA8 images would be ~48 MB for
the same three 2048^2 maps).

The per-material block rects live inside the packed material row, so there
is no separate rect-table gather at all. The emissive-only fetch on the
NEE light-eval path reads just block B.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..core.gather import shift_gather_rows

BLOCK_CHANNELS = 8
# block A channels
COLOR = slice(0, 3)
METALNESS = 3
ROUGHNESS = 4
NORMAL_RG = slice(5, 7)
# block B channels
EMISSIVE = slice(0, 3)


class AtlasPlane(NamedTuple):
    data: jnp.ndarray  # [H*W, 8] bf16 flat rows
    width: jnp.ndarray  # scalar i32 row stride


class MaterialAtlas(NamedTuple):
    """Two independently-packed planes: BSDF blocks can be large textured
    maps; emissive blocks are usually 1x1, so their plane stays tiny and
    the per-hit emissive fetch contracts against a handful of rows."""

    bsdf: AtlasPlane
    emissive: AtlasPlane
    # per-plane constancy, shape-encoded ([0] = every block in the plane
    # is a 1x1 constant) so shading can branch statically under jit: a
    # constant plane's values live in the packed material row and its
    # gathers are skipped entirely per shade. Emissive planes
    # are constant in most textured scenes, and fully-constant scenes
    # (procedural benches, furnace tests) skip the atlas altogether.
    bsdf_token: jnp.ndarray
    emissive_token: jnp.ndarray
    # shape-encoded: [0] = every material's normal map is the flat
    # constant (0.5, 0.5). The shading-normal chain then ends at the
    # vertex frame (texture frame == vertex frame mathematically), so the
    # integrator statically skips the normal decode + texture-frame
    # construction + the first leg of the fallback chain
    # (integrator.hlsl:93-104 degenerates the same way for flat maps).
    normal_token: jnp.ndarray

    @property
    def bsdf_constant(self) -> bool:
        return self.bsdf_token.shape[0] == 0

    @property
    def emissive_constant(self) -> bool:
        return self.emissive_token.shape[0] == 0

    @property
    def all_constant(self) -> bool:
        return self.bsdf_constant and self.emissive_constant

    @property
    def normals_flat(self) -> bool:
        return self.normal_token.shape[0] == 0


def _as_image(source, channels: int) -> np.ndarray:
    """Constant or [h,w,c] image -> [h,w,channels] float32."""
    src = np.asarray(source, np.float32)
    if src.ndim <= 1:
        v = np.broadcast_to(src.reshape(-1)[:channels], (channels,))
        if src.ndim == 0 or src.size < channels:
            v = np.full(channels, float(src.reshape(-1)[0]), np.float32) \
                if src.size == 1 else np.resize(src, channels)
        return np.asarray(v, np.float32).reshape(1, 1, channels)
    if src.ndim == 2:
        src = src[..., None]
    return src[..., :channels].astype(np.float32) if src.shape[-1] >= channels \
        else np.concatenate(
            [src, np.ones((*src.shape[:2], channels - src.shape[-1]), np.float32)],
            axis=-1,
        )


def _resize_bilinear_wrap(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Upsample with the same repeat-wrap bilinear used at runtime."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    ih, iw = img.shape[:2]
    v = (np.arange(h) + 0.5) / h * ih - 0.5
    u = (np.arange(w) + 0.5) / w * iw - 0.5
    v0 = np.floor(v).astype(np.int64)
    u0 = np.floor(u).astype(np.int64)
    fv = (v - v0)[:, None, None]
    fu = (u - u0)[None, :, None]
    v0w, v1w = v0 % ih, (v0 + 1) % ih
    u0w, u1w = u0 % iw, (u0 + 1) % iw
    top = img[v0w][:, u0w] * (1 - fu) + img[v0w][:, u1w] * fu
    bot = img[v1w][:, u0w] * (1 - fu) + img[v1w][:, u1w] * fu
    return top * (1 - fv) + bot * fv


def _pack_block(imgs) -> np.ndarray:
    h = max(im.shape[0] for _, im in imgs)
    w = max(im.shape[1] for _, im in imgs)
    block = np.zeros((h, w, BLOCK_CHANNELS), np.float32)
    for where, im in imgs:
        block[..., where] = _resize_bilinear_wrap(im, h, w)
    return block


def _pack_plane(blocks) -> tuple[AtlasPlane, np.ndarray]:
    """Shelf-pack blocks into one plane; returns (plane, rects [n,4]).

    Each block is stored with a one-texel wrap border on its right/bottom
    edges (row h = row 0, col w = col 0), so a bilinear fetch's four taps
    are always the fixed row shifts (+0, +1, +stride, +stride+1) of the
    top-left tap — the precondition for gather.shift_gather_rows. The
    borders lie inside the plane, so no tap reads past it. rects stay
    logical (x, y, w, h)."""
    max_w = max(b.shape[1] for b in blocks) + 1
    atlas_w = max(_next_pow2(max_w), 16)
    total = sum((b.shape[0] + 1) * (b.shape[1] + 1) for b in blocks)
    while atlas_w * atlas_w < total * 1.4 and atlas_w < 16384:
        atlas_w *= 2

    order = sorted(range(len(blocks)), key=lambda i: -blocks[i].shape[0])
    rects = np.zeros((len(blocks), 4), np.int32)
    shelf_x = shelf_y = shelf_h = 0
    for i in order:
        h, w, _ = blocks[i].shape
        if shelf_x + w + 1 > atlas_w:
            shelf_y += shelf_h
            shelf_x, shelf_h = 0, 0
        rects[i] = (shelf_x, shelf_y, w, h)
        shelf_x += w + 1
        shelf_h = max(shelf_h, h + 1)
    atlas_h = _next_pow2(shelf_y + shelf_h)

    data = np.zeros((atlas_h, atlas_w, BLOCK_CHANNELS), np.float32)
    for i, b in enumerate(blocks):
        x, y, w, h = rects[i]
        data[y : y + h, x : x + w] = b
        data[y + h, x : x + w] = b[0]  # bottom wrap border
        data[y : y + h, x + w] = b[:, 0]  # right wrap border
        data[y + h, x + w] = b[0, 0]
    plane = AtlasPlane(
        data=jnp.asarray(data.reshape(-1, BLOCK_CHANNELS), jnp.bfloat16),
        width=jnp.asarray(atlas_w, jnp.int32),
    )
    return plane, rects


class MaterialBlockBuilder:
    """Host-side packer: add() appends one material (BSDF block + emissive
    block); build() returns the two-plane atlas plus both rect arrays."""

    def __init__(self):
        self.bsdf_blocks: list[np.ndarray] = []
        self.emissive_blocks: list[np.ndarray] = []
        # constant values per material (valid when all maps are 1x1):
        # color3 | metalness | roughness | emissive3 | normal_rg2
        self.constants: list[np.ndarray] = []
        self.bsdf_textured = False
        self.emissive_textured = False
        self.normals_flat = True

    def add(self, color, metalness, roughness, emissive, normal_rg) -> int:
        nrm = _as_image(normal_rg, 2)
        if nrm.shape[:2] != (1, 1) or not np.all(nrm == 0.5):
            self.normals_flat = False
        a = _pack_block([
            (COLOR, _as_image(color, 3)),
            (slice(METALNESS, METALNESS + 1), _as_image(metalness, 1)),
            (slice(ROUGHNESS, ROUGHNESS + 1), _as_image(roughness, 1)),
            (NORMAL_RG, _as_image(normal_rg, 2)),
        ])
        b = _pack_block([
            (EMISSIVE, _as_image(emissive, 3)),
        ])
        self.bsdf_blocks.append(a)
        self.emissive_blocks.append(b)
        if a.shape[:2] != (1, 1):
            self.bsdf_textured = True
        if b.shape[:2] != (1, 1):
            self.emissive_textured = True
        self.constants.append(np.concatenate([
            a[0, 0, COLOR], a[0, 0, METALNESS:METALNESS + 1],
            a[0, 0, ROUGHNESS:ROUGHNESS + 1], b[0, 0, EMISSIVE],
            a[0, 0, NORMAL_RG],
        ]))
        return len(self.bsdf_blocks) - 1

    def build(self):
        """Returns (MaterialAtlas, rects [n, 2, 4] int32 (x, y, w, h) —
        [:, 0] in the bsdf plane, [:, 1] in the emissive plane — and
        constants [n, 10] f32, valid when atlas.all_constant)."""
        if not self.bsdf_blocks:
            self.add((1, 1, 1), 0.0, 1.0, (0, 0, 0), (0.5, 0.5))
        bsdf, rects_a = _pack_plane(self.bsdf_blocks)
        emissive, rects_b = _pack_plane(self.emissive_blocks)
        atlas = MaterialAtlas(
            bsdf=bsdf, emissive=emissive,
            bsdf_token=jnp.zeros(
                (1 if self.bsdf_textured else 0,), jnp.uint8),
            emissive_token=jnp.zeros(
                (1 if self.emissive_textured else 0,), jnp.uint8),
            normal_token=jnp.zeros(
                (0 if self.normals_flat else 1,), jnp.uint8),
        )
        return atlas, np.stack([rects_a, rects_b], axis=1), np.stack(
            self.constants)


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def sample_material_block(plane: AtlasPlane, rect: jnp.ndarray,
                          uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear repeat-wrap fetch of full material blocks from one plane.

    rect: [N, 4] float or int (x, y, w, h); uv: [N, 2] -> [N, 8] f32.

    Blocks carry wrap borders (_pack_plane), so only the top-left tap
    wraps; the other three taps are the fixed shifts (+1, +stride,
    +stride+1) and the whole filter is one shift gather
    (gather.shift_gather_rows).
    """
    x0 = rect[..., 0].astype(jnp.int32)
    y0 = rect[..., 1].astype(jnp.int32)
    tw = rect[..., 2].astype(jnp.float32)
    th = rect[..., 3].astype(jnp.float32)

    u = uv[..., 0] * tw - 0.5
    v = uv[..., 1] * th - 0.5
    iu = jnp.floor(u)
    iv = jnp.floor(v)
    fu1 = u - iu
    fv1 = v - iv

    wrap = lambda i, n: jnp.mod(i.astype(jnp.int32), n.astype(jnp.int32))
    iu0 = wrap(iu, tw)
    iv0 = wrap(iv, th)

    stride = plane.width
    base = (y0 + iv0) * stride + (x0 + iu0)
    weights = jnp.stack(
        [(1 - fu1) * (1 - fv1), fu1 * (1 - fv1), (1 - fu1) * fv1, fu1 * fv1],
        axis=-1,
    )
    return shift_gather_rows(plane.data, base, (0, 1, stride, stride + 1),
                             weights)
