"""select_us (us): the window's seconds over (decode steps x layers), the
window closed by a device synchronisation: one layer's selection for the
whole batch (host clock)."""


def read(rec):
    steps, layers = rec.counters.get("steps"), rec.counters.get("layers")
    if not steps or not layers:
        return None
    return rec.window_s / (steps * layers) * 1e6
