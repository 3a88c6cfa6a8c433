"""States a device call of the diver search evaluates: the program's counters DiverAgent.bsf_states over DiverAgent.bsf_calls across the traced groups; None where the program has no such counters."""


def read(run):
    c = run.trace.counters
    if not c.get("bsf_calls") or "bsf_states" not in c:
        return None
    return c["bsf_states"] / c["bsf_calls"]
