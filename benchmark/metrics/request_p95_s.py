"""request_p95_s: the 95th percentile (nearest rank) of the host seconds
of every request of the window, from the call of ``generate_conformers``
to its return. A failed request counts as missing it: infinite."""

import math


def read(run):
    if not run.units:
        return None
    times = sorted(math.inf if u.get("error") else u["end"] - u["start"]
                   for u in run.units)
    return times[math.ceil(0.95 * len(times)) - 1]
