"""Helpers the metric readers share."""


def per_job(run, get):
    """The mean over the window's jobs of ``get(job)``, or None where a
    job has no reading."""
    vals = [get(j) for j in run["jobs"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
