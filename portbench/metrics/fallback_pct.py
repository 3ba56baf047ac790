"""Reads corrected on the host over the reads corrected, in %: the sum
over every top-level batch of ``last_stats["fallback"]`` over the sum of
``last_stats["total"]``, over the window's jobs."""


def read(run):
    total = sum(j["counters"]["reads"] for j in run["jobs"])
    if not total:
        return None
    return 100.0 * sum(j["counters"]["fallback"] for j in run["jobs"]) / total
