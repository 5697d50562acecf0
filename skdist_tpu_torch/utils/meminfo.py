"""Best-effort host memory budget for the densification guardrail
(a copy of ``densify_budget_bytes`` from ``skdist_tpu/utils/meminfo.py``)."""

import os

#: explicit operator override (bytes) for the densification budget
BUDGET_ENV = "SKDIST_DENSIFY_BUDGET_BYTES"


def available_host_bytes():
    """Currently-available physical host memory, or None off-POSIX."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None


def densify_budget_bytes():
    """(budget, source_description) for a full densified allocation on
    the host; (None, "") when nothing can be determined."""
    env = os.environ.get(BUDGET_ENV)
    if env:
        try:
            return int(float(env)), f"{BUDGET_ENV} override"
        except ValueError:
            pass
    host = available_host_bytes()
    if host:
        return host, "available host RAM"
    return None, ""
