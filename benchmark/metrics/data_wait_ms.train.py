"""data_wait_ms.train: the host's wait for each training batch, the span
around `next(loader)` (the port's `data/loader.py` stream), mean per
iteration over the window, in ms."""


def read(record):
    waits = record.window.spans.get("data_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
