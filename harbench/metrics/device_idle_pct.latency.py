"""The share of the traced window in which no operation ran on the device: 1 − the
union of the device operations' intervals ÷ the window, in %."""
from harbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
