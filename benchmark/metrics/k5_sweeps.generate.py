"""k5_sweeps.generate: the Gauss-Newton iterations that kernel K5 computed
per solve in the traced stretch (the program's sweep counter, every AL
round, over the stretch's periods times the batch); the budget is
gn_iters x al_iters.  An iteration that repeats one which took no step is
skipped and not counted.  None where the record holds no count (a program
without the counter)."""


def read(rec):
    sweeps = rec.get("k5_sweeps")
    if not sweeps:
        return None
    return sum(sweeps) / (rec["periods"] * rec["batch"])
