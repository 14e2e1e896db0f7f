"""first_period_s: seconds of the program's first periods, the sum of its
kept ``period.first`` spans (``forging_control_tpu_torch.utils.profiling``
``spans()``): each from the eager start of a new graph's first period to
the end of the graph's instantiation.  Normally one, the warm-up's; a
capture inside the window would add its own.  None where the program keeps
no such span."""


def read(rec):
    from forging_control_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    firsts = [s["end"] - s["start"] for s in spans()
              if s["name"] == "period.first" and s["end"] is not None]
    return sum(firsts) if firsts else None
