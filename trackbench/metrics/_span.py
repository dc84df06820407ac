"""A span's seconds in the traced frames, from the trace's reduction."""


def span_s(ctx, name: str, side: str):
    s = ctx["trace"]["spans"].get(name)
    return None if s is None or s["count"] == 0 else s[side]
