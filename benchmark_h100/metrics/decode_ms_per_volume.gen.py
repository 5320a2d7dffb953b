"""Host-clock seconds of each call's decode chunks, synchronised at both ends,
summed over the window and divided by the volumes decoded (traced run)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "generate_3d" or w.get("decode_s") is None or not w["samples"]:
        return None
    return 1e3 * w["decode_s"] / w["samples"]
