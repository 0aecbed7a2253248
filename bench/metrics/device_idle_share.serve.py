"""The share of the traced stretch in which no operation ran on the
device, in percent."""

from bench import readings


def read(rec):
    return readings.idle_share(rec)
