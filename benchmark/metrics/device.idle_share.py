"""The share of the traced window in which no device operation ran, in %:
1 - busy / window, busy the union of the device operations' intervals."""


def read(run):
    if not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
