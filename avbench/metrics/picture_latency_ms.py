"""picture_latency_ms (ms, lower is better; host clock): the mean over the
window's pictures of the time from the start of send_data for the
picture's temporal unit to the return of the get_picture that hands it
out."""


def read(run):
    lat = run.window.latencies
    return 1e3 * sum(lat) / len(lat) if lat else None
