"""gvr_passes.select (passes): the mean over rows and calls of
`SelectorOutput.secant_iters` + 1, kept on the device over the counted
steps after the window (layer: DSA selection)."""


def read(rec):
    return rec.counters.get("gvr_passes_mean")
