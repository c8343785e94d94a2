"""Mean over the window's prompt switches of the time from a switch being
posted (at a segment boundary, right after the previous segment shipped)
to the first segment under the new prompt being shipped."""


def read(rec, ctx):
    s = rec.get("switch_ms")
    return sum(s) / len(s) if s else None
