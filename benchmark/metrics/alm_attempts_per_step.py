"""Solve attempts a step: the ALM driver's retry ladder (1 when the first
attempt converges and passes the f64 mass audit)."""


def read(run):
    vals = [r["attempts"] for r in run.records if "attempts" in r]
    return sum(vals) / len(vals) if vals else None
