"""The 95th percentile, over every request sent in the window, of the time
from when it was due to its answer (a failed or missing one counts with
the time it waited until the run ended)."""

import numpy as np


def read(run):
    latencies = run.record.get("latencies_s")
    return None if latencies is None else 1e3 * float(np.percentile(latencies, 95))
