"""Share of the traced window, in %, in which no operation ran on the
card: 100 x (1 - the union of the device operations' intervals over the
window)."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
