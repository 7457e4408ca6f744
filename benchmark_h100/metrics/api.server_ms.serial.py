"""Mean server-side milliseconds a request with one request in flight: the app's own
request-duration histogram (``monitoring/metrics.py``, fed by the
middleware in ``api/app.py``), sum and count over the window."""


def read(t: dict):
    http = t.get("http")
    if not http or not http["count"]:
        return None
    return 1e3 * http["sum_s"] / http["count"]
