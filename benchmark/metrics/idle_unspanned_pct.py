"""The traced window's device-idle time under no span of the program,
as a share of all its device-idle time: the idle the spans leave
unnamed (the device trace joined with the spans on the shared clock)."""
import spans


def read(run):
    return spans.idle_unspanned_pct(run)
