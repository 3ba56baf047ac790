"""Reads written by the window's jobs over the summed wall time of those
jobs (each from ``cli.main``'s call to its return, device synchronised)."""


def read(run):
    jobs = [j for j in run["jobs"] if j["rc"] == 0 and not j["error"]]
    wall = sum(j["wall_s"] for j in jobs)
    return sum(j["reads"] for j in jobs) / wall if wall > 0 else None
