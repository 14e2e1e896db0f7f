"""Driver of the dataset-generation cells: the batched driver's calls
(``drivers/batched.py``: one ``run_batch`` call a trajectory batch, calls
back to back; its set-up, window and sampled streams unchanged), whose
traced stretch also reads how many Gauss-Newton iterations kernel K5
computed.

The count is the program's own (``forging_control_tpu_torch.ops.ilqr``
``kernel_sweeps``, per AL round, summed over scenarios): reset before the
traced call and read after it, outside the profiler, into the record's
``k5_sweeps``.  Where the program has no such counter, or K5 does not run
on the cell's device, the record holds none.
"""

from __future__ import annotations

from . import batched


def sweep_counter(device):
    """The program's reader of K5's sweep counter for ``device``, or None
    where the program keeps none or does not run K5 there."""
    from forging_control_tpu_torch.ops import build, ilqr
    read = getattr(ilqr, "kernel_sweeps", None)
    return read if read is not None and build.on_card(device) else None


class Cell(batched.Cell):
    def traced(self, trace_seconds):
        read = sweep_counter(self.device)
        if read is not None:
            read(reset=True)
        rec = super().traced(trace_seconds)
        if read is not None:
            rec["k5_sweeps"] = read()
        return rec
