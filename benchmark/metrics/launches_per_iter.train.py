"""launches_per_iter.train: the device's kernel records in the traced block
(its iterations and the Fisher round among them) over its iterations: an
exact count of what the host dispatches (`train/steps.py::run_iteration`)."""


def read(record):
    cap, iters = record.capture, record.window.traced_work.get("iteration")
    if cap is None or not iters or not cap.kernels:
        return None
    return len(cap.kernels) / iters
