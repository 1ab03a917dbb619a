"""Host milliseconds a batch the loop waits for device_prefetch's next
item, mean over the window's batches."""


def read(record):
    b = record["batches"]
    return 1e3 * sum(x["wait_s"] for x in b) / len(b)
