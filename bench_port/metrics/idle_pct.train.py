"""Share of the profiled segment in which no operation ran on the card."""


def read(run):
    return 100.0 * (1.0 - run.busy_us() / run.window_us[1])
