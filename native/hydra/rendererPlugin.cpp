/* See rendererPlugin.hpp. */

#include "rendererPlugin.hpp"

#include <pxr/imaging/hd/rendererPluginRegistry.h>

#include "renderDelegate.hpp"

PXR_NAMESPACE_OPEN_SCOPE

TF_REGISTRY_FUNCTION(TfType) {
    HdRendererPluginRegistry::Define<HdMoonshineTpuPlugin>();
}

HdRenderDelegate* HdMoonshineTpuPlugin::CreateRenderDelegate() {
    return new HdMoonshineTpuRenderDelegate();
}

HdRenderDelegate* HdMoonshineTpuPlugin::CreateRenderDelegate(
    HdRenderSettingsMap const& settingsMap) {
    return new HdMoonshineTpuRenderDelegate(settingsMap);
}

void HdMoonshineTpuPlugin::DeleteRenderDelegate(
    HdRenderDelegate* renderDelegate) {
    delete renderDelegate;
}

bool HdMoonshineTpuPlugin::IsSupported(bool) const {
    /* the engine renders on whatever device JAX selected (GPU or CPU);
     * JAX_PLATFORMS pins it */
    return true;
}

PXR_NAMESPACE_CLOSE_SCOPE
