"""step_ms_p95: the 95th percentile over every step of the window, each
step timed on the host clock from its start to the host's read of its done
codes (and commands); linear interpolation between order statistics."""

import numpy as np


def read(ctx, suffix):
    return float(np.percentile(np.asarray(ctx["window"]["step_s"]), 95)
                 * 1e3)
