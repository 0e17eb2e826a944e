"""The host's wait for the device a step: the time of the `sync` spans,
each a host read of a device value (the stepper's counted syncs,
GMRES's flag reads, the ALM diagnostics pull)."""
import spans


def read(run):
    return spans.self_ms_per_step(run, ("sync",))
