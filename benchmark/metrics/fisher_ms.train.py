"""fisher_ms.train: one Fisher round (`train/fisher.py::fisher_round` and the
masks' merge, `train/masks.py`), the span around it synchronized at both
ends, mean per round over the window, in ms."""


def read(record):
    rounds = record.window.spans.get("fisher")
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
