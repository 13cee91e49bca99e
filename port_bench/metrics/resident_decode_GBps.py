"""Original GB made usable per second: the decoded bytes of every unit
the window completed over the window's host-clock seconds."""


def read(run):
    w = run["window"]
    return w["bytes"] / w["seconds"] / 1e9 if w["seconds"] else None
