# Blender add-on registering the moonshine_tpu Hydra delegate as a render
# engine (parity target: reference hydra/blender.py). The built
# hdMoonshineTpu.so directory must be on PXR_PLUGINPATH_NAME.

import bpy


class MoonshineTpuRenderEngine(bpy.types.HydraRenderEngine):
    bl_idname = "HYDRA_MOONSHINE_TPU"
    bl_label = "Moonshine (JAX)"

    bl_use_preview = True
    bl_use_gpu_context = False
    bl_use_materialx = False

    bl_delegate_id = "HdMoonshineTpuPlugin"

    def view_draw(self, context, depsgraph):
        super().view_draw(context, depsgraph)
        # progressive accumulation: keep asking for frames so samples keep
        # accumulating while the viewport is open
        self.tag_redraw()


register, unregister = bpy.utils.register_classes_factory(
    (MoonshineTpuRenderEngine,)
)

if __name__ == "__main__":
    register()
