"""Updates of the window whose batch overflowed the restricted final
layer's plan and took the full layer (the port's
``final_layer_restricted.fallbacks``), over the window's updates."""


def read(layer, trace):
    if not layer.get("restricted") or not layer.get("updates_window"):
        return None
    return 100.0 * layer["fallbacks_window"] / layer["updates_window"]
