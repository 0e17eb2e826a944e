"""Newton iterations a step: the batched stepper's iterations (the batch
iterates until its last column stops), summed over its dt cuts; for the
ALM step those of the ladder's last attempt."""


def read(run):
    vals = [r["newton_iters"] for r in run.records if "newton_iters" in r]
    return sum(vals) / len(vals) if vals else None
