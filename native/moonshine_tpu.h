/* moonshine_tpu C ABI — the DCC-integration surface.
 *
 * Role parity with the reference's hydra/moonshine.h:72-95: an opaque
 * engine object plus u32 handles for meshes/images/materials/instances/
 * sensors/lenses, driven by a host application (USD Hydra delegate,
 * Blender add-on, game editor). The implementation (engine_shim.cpp)
 * embeds a Python interpreter running the JAX engine; callers need no
 * Python of their own. The engine runs on the device JAX picks; set
 * JAX_PLATFORMS in the host's environment to pin one.
 */

#pragma once

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef uint32_t MsnMeshHandle;
typedef uint32_t MsnImageHandle;
typedef uint32_t MsnMaterialHandle;
typedef uint32_t MsnSensorHandle;
typedef uint32_t MsnLensHandle;
typedef uint32_t MsnInstanceHandle;

typedef struct MsnF32x2 { float x, y; } MsnF32x2;
typedef struct MsnF32x3 { float x, y, z; } MsnF32x3;
typedef struct MsnMat3x4 { float m[12]; /* row-major 3x4 */ } MsnMat3x4;
typedef struct MsnU32x3 { uint32_t x, y, z; } MsnU32x3;

typedef struct MsnGeometry {
    MsnMeshHandle mesh;
    MsnMaterialHandle material;
    bool sampled;
} MsnGeometry;

typedef struct MsnExtent2D { uint32_t width, height; } MsnExtent2D;

typedef struct MsnLens {
    MsnF32x3 origin;
    MsnF32x3 forward;
    MsnF32x3 up;
    float vfov;
    float aperture;
    float focus_distance;
} MsnLens;

typedef struct MsnMaterial {
    /* image handles; normal may be MSN_NO_IMAGE */
    MsnImageHandle normal;
    MsnImageHandle emissive;
    MsnImageHandle color;
    MsnImageHandle metalness;
    MsnImageHandle roughness;
    float ior;
} MsnMaterial;

#define MSN_NO_IMAGE ((MsnImageHandle)0xFFFFFFFFu)

typedef enum MsnTextureFormat {
    MSN_TEXTURE_F16X4 = 0,
    MSN_TEXTURE_U8X4_SRGB = 1,
} MsnTextureFormat;

typedef struct MsnEngine MsnEngine;

MsnEngine *MsnCreate(void);
void MsnDestroy(MsnEngine *);
bool MsnRender(MsnEngine *, MsnSensorHandle, MsnLensHandle);
bool MsnRebuildPipeline(MsnEngine *);

/* positions required; normals/texcoords optional (NULL). Attribute counts
 * may be vertex-indexed (== position count) or flat per-corner
 * (3 * index count), matching the reference's indexed_attributes modes. */
MsnMeshHandle MsnCreateMesh(MsnEngine *, const MsnF32x3 *positions,
                            size_t position_count, const MsnF32x3 *normals,
                            size_t normal_count, const MsnF32x2 *texcoords,
                            size_t texcoord_count, const MsnU32x3 *indices,
                            size_t index_count);

MsnImageHandle MsnCreateSolidTexture1(MsnEngine *, float);
MsnImageHandle MsnCreateSolidTexture2(MsnEngine *, MsnF32x2);
MsnImageHandle MsnCreateSolidTexture3(MsnEngine *, MsnF32x3);
MsnImageHandle MsnCreateRawTexture(MsnEngine *, const uint8_t *data,
                                   MsnExtent2D, MsnTextureFormat);

MsnMaterialHandle MsnCreateMaterial(MsnEngine *, MsnMaterial);
void MsnSetMaterialNormal(MsnEngine *, MsnMaterialHandle, MsnImageHandle);
void MsnSetMaterialEmissive(MsnEngine *, MsnMaterialHandle, MsnImageHandle);
void MsnSetMaterialColor(MsnEngine *, MsnMaterialHandle, MsnImageHandle);
void MsnSetMaterialMetalness(MsnEngine *, MsnMaterialHandle, MsnImageHandle);
void MsnSetMaterialRoughness(MsnEngine *, MsnMaterialHandle, MsnImageHandle);
void MsnSetMaterialIOR(MsnEngine *, MsnMaterialHandle, float);

MsnInstanceHandle MsnCreateInstance(MsnEngine *, MsnMat3x4,
                                    const MsnGeometry *, size_t count,
                                    bool visible);
void MsnDestroyInstance(MsnEngine *, MsnInstanceHandle);
void MsnSetInstanceTransform(MsnEngine *, MsnInstanceHandle, MsnMat3x4);
void MsnSetInstanceVisibility(MsnEngine *, MsnInstanceHandle, bool);

MsnSensorHandle MsnCreateSensor(MsnEngine *, MsnExtent2D);
/* persistent RGBA f32 host buffer, refreshed by MsnRender */
float *MsnGetSensorData(const MsnEngine *, MsnSensorHandle);
uint32_t MsnGetSensorSampleCount(const MsnEngine *, MsnSensorHandle);

MsnLensHandle MsnCreateLens(MsnEngine *, MsnLens);
void MsnSetLens(MsnEngine *, MsnLensHandle, MsnLens);

/* --- EXR codec (tinyexr role, fileformats/exr.zig parity) --- */

/* Writes [height*width*3 or *4] float32 scanlines as a ZIP-compressed EXR.
 * Returns 0 on success. */
int MsnExrWrite(const char *path, const float *rgb, uint32_t width,
                uint32_t height, uint32_t channels);

/* Like MsnExrWrite with an explicit compression: 3 = ZIP, 4 = PIZ. */
int MsnExrWrite2(const char *path, const float *rgb, uint32_t width,
                 uint32_t height, uint32_t channels, uint32_t compression);

/* Loads an EXR (NONE/RLE/ZIPS/ZIP/PIZ, half/float) as RGBA float32. The
 * buffer is malloc'd; caller frees with MsnExrFree. Returns 0 on success. */
int MsnExrRead(const char *path, float **out_rgba, uint32_t *out_width,
               uint32_t *out_height);
void MsnExrFree(float *);

#ifdef __cplusplus
}
#endif
