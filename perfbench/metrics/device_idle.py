"""`device_idle.<cells>`: share of the profiled slice with no operation
running on the device. In %."""

from perfbench import yardstick


def read(run: dict):
    return yardstick.idle_share(run)
