"""Mean host milliseconds from a train-step call to its return, without a
synchronisation: near the step time where the host waits for the card,
below it where the host runs ahead."""


def read(ctx):
    host = ctx["window"].get("step_host_s")
    if ctx["role"] != "train" or not host:
        return None
    return 1e3 * sum(host) / len(host)
