"""decode_tok_s (tokens/s): tokens the engine delivered in the window, over
all slots, divided by the window's seconds (host clock)."""


def read(rec):
    n = rec.counters.get("decoded_tokens")
    return None if n is None or rec.window_s <= 0 else n / rec.window_s
