"""prior_hit_pct.select (%): the share of each row's new Top-K found in its
previous Top-K (a copy of `core.temporal.hit_ratio`), over the counted
steps after the window (layer: DSA selection)."""


def read(rec):
    share = rec.counters.get("prior_hit_share")
    return None if share is None else 100.0 * share
