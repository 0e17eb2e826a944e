"""GMRES Arnoldi steps a step on the card (ilu_gmres.CARD_CALLS)."""


def read(run):
    vals = [r["arnoldi_steps"] for r in run.records if "arnoldi_steps" in r]
    return sum(vals) / len(vals) if vals else None
