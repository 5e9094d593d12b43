"""Seconds from the process's start to the window's: imports, weights
made on the device, the kernel library built or loaded, the gateway's
discovery, the warm-up calls and the traffic's lead-in."""


def read(run: dict):
    return run["setup_s"]
