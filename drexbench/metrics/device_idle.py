"""Share of the traced window in which no operation ran on the card.

One reader for every ``device_idle.<cell kind>`` metric: each moves its
own cell's end-to-end metric, and the quantity is the same."""


def read(rec):
    if rec.dev is None or rec.dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.dev.busy_s / rec.dev.window_s)
