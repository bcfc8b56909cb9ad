"""frames_per_s: the answers back on the host over the window, which ends
with the last answer."""


def read(rec):
    w = rec["window"]
    return w["units"] / w["seconds"] if w["units"] else None
