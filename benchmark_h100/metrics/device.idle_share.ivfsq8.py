"""The device's idle share of the profiled slice: 1 - (the union of
its events' intervals / the slice's length), from torch.profiler."""


def read(t: dict):
    dev = t.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 1.0 - dev["busy_s"] / dev["window_s"]
