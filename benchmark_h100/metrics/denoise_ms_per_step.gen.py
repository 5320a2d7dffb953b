"""Host-clock seconds of each call's denoise, synchronised at both ends,
summed over the window and divided by its denoise steps (traced run)."""


def read(ctx):
    w = ctx["window"]
    if ctx["role"] != "gen" or w.get("denoise_s") is None or not w["steps"]:
        return None
    return 1e3 * w["denoise_s"] / w["steps"]
